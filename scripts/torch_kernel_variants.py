#!/usr/bin/env python3
"""Design variants of the port's ``segment_spmm``, ``cached_gather``,
``semantic_scores`` and ``semantic_combine`` CUDA kernels, timed against
each other on one GPU, in one process.

    python3 scripts/torch_kernel_variants.py [--parent ROOT] [--stamps]
        [--only spmm gather scores combine]

Each variant is this checkout's CUDA source with a few of its constants or
lines replaced (``SPMM``, ``GATHER``, ``SCORES`` and ``COMBINE`` below),
built on its own with ``kernels/build.py``'s flags into
``build/variants/<name>/`` and called through its C launcher with
``ctypes``.  ``--parent ROOT`` adds another checkout's sources as they are
(either launcher signature of ``cached_gather``: the one that takes a
filled cache section is given one, filled inside the timed call as its
wrapper fills it; either of ``semantic_scores``: the two-launch one takes
no counter).  ``--only`` picks the kernels (default: all four).  A
variant that keeps the port's order of sums is held bitwise against the
port's own kernel on the same inputs; one that changes it
(``semantic_scores``' ``tile32`` and ``tc``) within ``chip_smoke.py``'s
``TOL_SCORES`` of the plain version.

Inputs: the four relations of RGCN/imdb (layer-0 projected features as
``h_src``, the padded ``[N, 64]`` layout) and the K = 64 buckets of their
3-bucket layout; the six instance positions of a MAGNN/imdb layer with 256
hot rows a type (strided ``[4278, 16]`` index views); MAGNN/imdb's stacked
NA output ``z [2, 4278, 64]`` with its SA parameters (W ``[64, 128]``) for
both SA passes, ``beta`` the softmax of its scores.  Times are CUDA
events, the median of 50 calls, cold (the 50 MB L2 flushed before each
call) and warm, as ``chip_smoke.py`` times its kernels; a ``layer`` is the
launches of one layer back to back.  ``launch_only`` is a kept kernel
returning at once: the floor that launching and timing one kernel sets.
``fill_`` and ``copy_`` of one position's output (17.5 MB) are the
yardstick of writing it.

``--stamps`` also runs the kept ``segment_spmm`` and ``semantic_scores``
with ``clock64`` stamps at their phases (thread 0 of every block) and
prints each phase's median and largest cycles over the blocks.  The last
line is one JSON object.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "variants"
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
GROUPS = ("spmm", "gather", "scores", "combine")

# name -> [(text in csrc/segment_spmm.cu, replacement)]
SPMM = {
    "kept": [],
    "rows32": [("constexpr int kRows = 16;", "constexpr int kRows = 32;")],
    "chunk64": [("constexpr int kChunk = 128;", "constexpr int kChunk = 64;")],
    "chunk64_stages4": [
        ("constexpr int kChunk = 128;", "constexpr int kChunk = 64;"),
        ("constexpr int kStages = 2;", "constexpr int kStages = 4;")],
    "unroll4": [("#pragma unroll 8\n      for (int e = max(off, lo)",
                 "#pragma unroll 4\n      for (int e = max(off, lo)")],
    "launch_only": [("  extern __shared__ __align__(16) float smem[];\n",
                     "  extern __shared__ __align__(16) float smem[];\n"
                     "  if (K >= 0) return;\n")],
}
# name -> [(text in csrc/feature_cache.cu, replacement)]
GATHER = {
    "kept": [],
    "plain_stores": [("__stcs(reinterpret_cast<float4*>(out",
                      "__stwb(reinterpret_cast<float4*>(out"),
                     ("__stcs(out + ", "__stwb(out + ")],
    "unroll2": [("constexpr int kUnroll = 4;", "constexpr int kUnroll = 2;")],
    "unroll8": [("constexpr int kUnroll = 4;", "constexpr int kUnroll = 8;")],
    "blocks4": [("constexpr int kBlocksPerSM = 8;",
                 "constexpr int kBlocksPerSM = 4;")],
    "no_prefetch": [
        ("    if (tile + gridDim.x < n_tiles)\n",
         "    if (false)\n"),
        ("  for (; tile < n_tiles; tile += gridDim.x) {\n",
         "  for (; tile < n_tiles; tile += gridDim.x) {\n"
         "    load_indices(idx, tile, grp, cols, stride_r, stride_c, total,"
         " i, v);\n")],
}
STAMP_NAMES = ["mask + ballot", "barrier 1", "offsets + list", "barrier 2",
               "first chunk landed", "sums", "mean + store"]
_STAMP = ("if (threadIdx.x == 0 && blockIdx.y == 0 && blockIdx.x < 4096) "
          "g_clk[{p}][blockIdx.x] = clock64();\n")
STAMPS = [  # the kept segment_spmm, a clock64 stamp at each phase
    ("namespace {\n", "namespace {\n__device__ long long g_clk[8][4096];\n"),
    ("  float deg = 0.f;\n", "  float deg = 0.f;\n  " + _STAMP.format(p=0)),
    ("    if (t % kLanesRow == 0) s_cnt[rr] = cnt;\n    __syncthreads();\n",
     "    if (w0 == 0) " + _STAMP.format(p=1) +
     "    if (t % kLanesRow == 0) s_cnt[rr] = cnt;\n    __syncthreads();\n"
     "    if (w0 == 0) " + _STAMP.format(p=2)),
    ("        ++at;\n      }\n    }\n    __syncthreads();\n",
     "        ++at;\n      }\n    }\n    if (w0 == 0) " + _STAMP.format(p=3) +
     "    __syncthreads();\n    if (w0 == 0) " + _STAMP.format(p=4)),
    ("      __syncthreads();  // every thread's copies of chunk ch have "
     "landed\n",
     "      __syncthreads();  // every thread's copies of chunk ch have "
     "landed\n      if (w0 == 0 && ch == 0) " + _STAMP.format(p=5)),
    ("  // 4. the mean", "  " + _STAMP.format(p=6) + "  // 4. the mean"),
    ("          if (cq + 4 * h + u < cw) o[4 * h + u] = av[u];\n      }\n"
     "    }\n  }\n",
     "          if (cq + 4 * h + u < cw) o[4 * h + u] = av[u];\n      }\n"
     "    }\n  }\n  " + _STAMP.format(p=7)),
    ("}  // namespace\n",
     "}  // namespace\nextern \"C\" int segment_spmm_stamps(long long* c) {\n"
     "  return (int)cudaMemcpyFromSymbol(c, g_clk, sizeof(g_clk));\n}\n"),
]

# name -> [(text in csrc/semantic_scores.cu, replacement)]; a replacement
# whose text is a pair (start, end) swaps everything from start up to end
_TC_HELPERS = """
__device__ __forceinline__ uint32_t tf32(float a) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(r) : "f"(a));
  return r;
}
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
"""
# The product on the tensor cores (64-row tiles only), mma.sync m16n8k8 in
# 3xTF32 (each operand split into a TF32 high part and a TF32 rest, acc +=
# lo hi + hi lo + hi hi): warp w owns rows 16 (w & 3) .. + 15 of a tile and
# the column half w >> 2 (8 n-tiles of 8 a chunk of 128); z's ring rows
# padded to 36 floats and W's rows to a multiple of 32 plus 8, so the
# fragments load without bank conflicts; the two halves' row scores are
# added per row.
_TC_LOOP = """  const int gq = lane >> 2, tq = lane & 3;
  const int m0 = 16 * (warp & 3);
  const int nb = (warp >> 2) * 64 * NC;
  constexpr int NT = 8 * NC;
  float acc[NT][4], bq[NT][2], qq[NT][2];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int cl = nb + 8 * j + 2 * tq + e;
      bq[j][e] = cl < Hs ? __ldg(bias + cl) : 0.f;
      qq[j][e] = cl < Hs ? __ldg(q + cl) : 0.f;
    }
  for (int s = 0; s < n_steps; ++s) {
    const int ch = s % nch;
    if (ch == 0) {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        acc[j][0] = bq[j][0];
        acc[j][1] = bq[j][1];
        acc[j][2] = bq[j][0];
        acc[j][3] = bq[j][1];
      }
    }
    issue(s + 1);
    asm volatile("cp.async.wait_group 1;\\n" ::: "memory");
    __syncthreads();
    const float* zs = ring + (s & 1) * kTile * kZLd;
    const int f0 = ch * kFC;
    const int fw = min(kFC, D4 - f0);
    for (int k0 = 0; k0 < fw; k0 += 8) {
      const float av[4] = {zs[(m0 + gq) * kZLd + k0 + tq],
                           zs[(m0 + gq + 8) * kZLd + k0 + tq],
                           zs[(m0 + gq) * kZLd + k0 + tq + 4],
                           zs[(m0 + gq + 8) * kZLd + k0 + tq + 4]};
      uint32_t ah[4], al[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        ah[i] = tf32(av[i]);
        al[i] = tf32(av[i] - __uint_as_float(ah[i]));
      }
      const int ka = f0 + k0 + tq, kb = ka + 4;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int cl = nb + 8 * j + gq;
        const float b[2] = {ka < D4 ? w_s[ka * ldw + cl] : 0.f,
                            kb < D4 ? w_s[kb * ldw + cl] : 0.f};
        uint32_t bh[2], bl[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          bh[h] = tf32(b[h]);
          bl[h] = tf32(b[h] - __uint_as_float(bh[h]));
        }
        mma_tf32(acc[j], al, bh[0], bh[1]);
        mma_tf32(acc[j], ah, bl[0], bl[1]);
        mma_tf32(acc[j], ah, bh[0], bh[1]);
      }
    }
    if (ch == nch - 1) {
      const int t = blockIdx.x + (s / nch) * gridDim.x;
      const int p = t / tpp;
      const int n0 = (t - p * tpp) * kTile;
      float sc[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (nb + 8 * j + 2 * tq + e < Hs) {
            sc[0] += qq[j][e] * tanhf(acc[j][e]);
            sc[1] += qq[j][e] * tanhf(acc[j][2 + e]);
          }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        sc[h] += __shfl_xor_sync(kFull, sc[h], 1);
        sc[h] += __shfl_xor_sync(kFull, sc[h], 2);
      }
      if (tq == 0) {
        float* rs = row_score + (warp >> 2) * kTile + m0 + gq;
        rs[0] = n0 + m0 + gq < N ? sc[0] : 0.f;
        rs[8] = n0 + m0 + gq + 8 < N ? sc[1] : 0.f;
      }
      __syncthreads();
      if (threadIdx.x == 0) {
        float v = 0.f;
        for (int r = 0; r < kTile; ++r)
          v += row_score[r] + row_score[kTile + r];
        partial[t] = v;
      }
    }
    __syncthreads();
  }
"""
_ROWS8 = ("  if (Hs > 128) return 8;\n", "  return 8;\n")
# W's rows of a chunk by one bulk copy (the TMA engine), completing on one
# of two mbarriers (chunk s on barrier s % 2), where W's rows are 16-byte
# aligned; z still by cp.async
_W_BULK = [
    ("  __shared__ int s_last;\n",
     "  __shared__ int s_last;\n"
     "  __shared__ __align__(8) uint64_t s_wbar[2];\n"),
    ("  issue(0);\n", """\
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\\n" ::"r"(
          smem_addr(&s_wbar[i])));
    asm volatile("fence.mbarrier_init.release.cluster;\\n" ::: "memory");
  }
  __syncthreads();
  issue(0);
"""),
    ("""\
      if (vec_w)
        copy_w<true>(w_s, W, s * kFC, k1, D, Hs, ldw);
      else""", """\
      if (vec_w) {
        const int kd = min(D, k1);
        if (threadIdx.x == 0) {
          const uint32_t bytes = (uint32_t)((kd - s * kFC) * Hs * 4);
          const uint32_t bar = smem_addr(&s_wbar[s & 1]);
          asm volatile(
              "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\\n"
              ::"r"(bar), "r"(bytes)
              : "memory");
          asm volatile(
              "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::"
              "bytes [%0], [%1], %2, [%3];\\n" ::"r"(
                  smem_addr(w_s + (size_t)s * kFC * ldw)),
              "l"(W + (size_t)s * kFC * Hs), "r"(bytes), "r"(bar)
              : "memory");
        }
        for (int i = kd * ldw + threadIdx.x; i < k1 * ldw; i += kThreads)
          w_s[i] = 0.f;
      } else"""),
    ('    asm volatile("cp.async.wait_group 1;\\n" ::: "memory");\n', """\
    asm volatile("cp.async.wait_group 1;\\n" ::: "memory");
    if (s < nch && vec_w) {
      const uint32_t bar = smem_addr(&s_wbar[s & 1]);
      const uint32_t parity = (s >> 1) & 1;
      asm volatile(
          "{\\n .reg .pred p;\\n WAIT_%=:\\n"
          " mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\\n"
          " @!p bra WAIT_%=;\\n}\\n" ::"r"(bar),
          "r"(parity)
          : "memory");
    }
"""),
]
# the same with W's rows padded to ldw (the tc variant's layout)
_W_CP_ASYNC_PADDED = [
    (("    for (int i = k0 * ldw / 4 + threadIdx.x; i < kd * ldw / 4;",
      "  } else {\n    for (int i = k0 * ldw + threadIdx.x;"), """\
    for (int i = k0 * ldw / 4 + threadIdx.x; i < k1 * ldw / 4;
         i += kThreads) {
      const int k = 4 * i / ldw, c = 4 * i % ldw;
      if (k < D && c < Hs)
        cp_async16(w_s + 4 * i, W + (size_t)k * Hs + c);
      else
        *reinterpret_cast<float4*>(w_s + 4 * i) =
            make_float4(0.f, 0.f, 0.f, 0.f);
    }
""")]
_BQ_BLOCK = """\
  // this lane's columns: col[c] .. col[c] + 3 (clamped to 0 past Hs, and
  // left out of the score); b and q of them
  int col[NC];
  float bv[NC][4], qv[NC][4];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int c0 = c * 128 + 4 * lane;
    col[c] = c0 < Hs ? c0 : 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      bv[c][j] = c0 + j < Hs ? __ldg(bias + c0 + j) : 0.f;
      qv[c][j] = c0 + j < Hs ? __ldg(q + c0 + j) : 0.f;
    }
  }

"""
# the next 4 features' z and W loaded into registers during these 4's FMAs
_PREFETCH = (("#pragma unroll 2\n    for (int f = 0; f < fw; f += 4) {",
              "    if (ch == nch - 1) {  // the tile's"), """\
    float4 zr[kR], wv[4][NC];
#pragma unroll
    for (int r = 0; r < kR; ++r)
      zr[r] = *reinterpret_cast<const float4*>(zs + r * kZLd);
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int c = 0; c < NC; ++c)
        wv[k][c] = *reinterpret_cast<const float4*>(
            w_s + (size_t)(f0 + k) * ldw + col[c]);
    for (int f = 0; f < fw; f += 4) {  // features in order
      float4 zn[kR], wn[4][NC];
      const int fn = f + 4 < fw ? f + 4 : f;
#pragma unroll
      for (int r = 0; r < kR; ++r)
        zn[r] = *reinterpret_cast<const float4*>(zs + r * kZLd + fn);
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int c = 0; c < NC; ++c)
          wn[k][c] = *reinterpret_cast<const float4*>(
              w_s + (size_t)(f0 + fn + k) * ldw + col[c]);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          const float zk = k == 0 ? zr[r].x
                         : k == 1 ? zr[r].y
                         : k == 2 ? zr[r].z
                                  : zr[r].w;
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            acc[r][c][0] = fmaf(zk, wv[k][c].x, acc[r][c][0]);
            acc[r][c][1] = fmaf(zk, wv[k][c].y, acc[r][c][1]);
            acc[r][c][2] = fmaf(zk, wv[k][c].z, acc[r][c][2]);
            acc[r][c][3] = fmaf(zk, wv[k][c].w, acc[r][c][3]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < kR; ++r) zr[r] = zn[r];
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int c = 0; c < NC; ++c) wv[k][c] = wn[k][c];
    }
""")
SCORES = {
    "kept": [],
    # 64-row tiles whatever the shape (at [2, 4278, 64]: 134 tiles, so two
    # blocks take two)
    "rows8": [_ROWS8],
    # 32-row tiles whatever the shape (268 at [2, 4278, 64]: blocks take 2-3)
    "rows4": [("  if (Hs > 128) return 8;\n",
               "  if (Hs > 128) return 8;\n  return 4;\n"),
              ("    SCORES_CASE(9)\n",
               "    SCORES_CASE(4)\n    SCORES_CASE(9)\n")],
    # W staged whole before the first chunk (not a chunk of rows at a time)
    "w_whole": [("    if (s < nch) {\n      const int k1 = min(D4, (s + 1) * "
                 "kFC);\n",
                 "    if (s == 0) {\n      const int k1 = D4;\n")],
    "w_bulk": _W_BULK,
    "unroll1": [("#pragma unroll 2\n    for (int f = 0; f < fw; f += 4) {",
                 "#pragma unroll 1\n    for (int f = 0; f < fw; f += 4) {")],
    "fc64": [("constexpr int kFC = 32;", "constexpr int kFC = 64;")],
    "tc": [_ROWS8] + _W_CP_ASYNC_PADDED + [
           ("inline int w_ld(int Hs) { return round4(Hs); }",
            "inline int w_ld(int Hs) { return ((Hs + 31) & ~31) + 8; }"),
           ("constexpr int kZLd = kFC;", "constexpr int kZLd = kFC + 4;"),
           ("(2 * (size_t)kZLd + 1) * kWarps * R);",
            "(2 * (size_t)kZLd + 2) * kWarps * R);"),
           ("__device__ __forceinline__ void cp_async4",
            _TC_HELPERS + "__device__ __forceinline__ void cp_async4"),
           (("  float acc[kR][NC][4];\n",
             '  asm volatile("cp.async.wait_group 0;'), _TC_LOOP)],
    "fc16": [("constexpr int kFC = 32;", "constexpr int kFC = 16;")],
    # b and q loaded after the first copies are issued (the same bits)
    "bq_late": [(("  // this lane's columns: col[c]",
                  "  // the ring: step s is chunk"), ""),
                ("  issue(0);\n", "  issue(0);\n" + _BQ_BLOCK)],

    # the ticket as __threadfence() then atomicAdd, and __threadfence() in
    # the last block (the parent's pattern)
    "fences": [("    int ticket;\n"
                '    asm volatile("atom.add.acq_rel.gpu.s32 %0, [%1], 1;\\n"\n'
                '                 : "=r"(ticket)\n'
                '                 : "l"(done)\n'
                '                 : "memory");\n'
                "    s_last = ticket == (int)gridDim.x - 1;\n",
                "    __threadfence();\n"
                "    s_last = atomicAdd(done, 1) == (int)gridDim.x - 1;\n"),
               ("  if (!s_last) return;\n",
                "  if (!s_last) return;\n  __threadfence();\n")],
    # the accumulators from 0 and b added before the tanh, so the product
    # need not wait for b
    "acc0": [("for (int j = 0; j < 4; ++j) acc[r][c][j] = bv[c][j];",
              "for (int j = 0; j < 4; ++j) acc[r][c][j] = 0.f;"),
             ("sc[r] += qv[c][j] * tanhf(acc[r][c][j]);",
              "sc[r] += qv[c][j] * tanhf(acc[r][c][j] + bv[c][j]);")],
    "prefetch": [_PREFETCH],
    "launch_only": [("  extern __shared__ __align__(16) float smem[];\n",
                     "  extern __shared__ __align__(16) float smem[];\n"
                     "  if (N >= 0) return;\n")],
    # diagnostics (wrong results, timing only): no W staging, no tanh
    "diag_no_w": [("    if (s < nch) {\n      const int k1",
                   "    if (false) {\n      const int k1")],
    "diag_no_tanh": [("sc[r] += qv[c][j] * tanhf(acc[r][c][j]);",
                      "sc[r] += qv[c][j] * acc[r][c][j];")],
}
# name -> [(text in csrc/semantic_combine.cu, replacement)]
COMBINE = {
    "kept": [],
    "per1": [("constexpr int kPer = 2;", "constexpr int kPer = 1;")],
    "per4": [("constexpr int kPer = 2;", "constexpr int kPer = 4;")],
    "scalar": [("const bool vec = nd % 4 == 0 &&",
                "const bool vec = false && nd % 4 == 0 &&")],
}
SCORES_STAMP_NAMES = ["first chunk (and its W) landed",
                      "chunk 0's product, chunk 1 landed",
                      "the rest of the first tile's product",
                      "first tile's scores + partial", "the other tiles",
                      "ticket"]
_SSTAMP = ("if (threadIdx.x == 0 && blockIdx.x < 1024) "
           "g_sclk[{p}][blockIdx.x] = clock64();\n")
SCORES_STAMPS = [  # the kept semantic_scores, a clock64 stamp at each phase
    ("namespace {\n", "namespace {\n__device__ long long g_sclk[8][1024];\n"
     "__device__ long long g_ssum[2];\n"),
    ("  const bool vec = D % 4 == 0 && reinterpret_cast<uintptr_t>(z) % 16 "
     "== 0;\n",
     "  const bool vec = D % 4 == 0 && reinterpret_cast<uintptr_t>(z) % 16 "
     "== 0;\n  " + _SSTAMP.format(p=0)),
    ("    __syncthreads();  // step s (and its W rows) landed, every "
     "thread's copies\n",
     "    __syncthreads();  // step s (and its W rows) landed, every "
     "thread's copies\n    if (s == 0) " + _SSTAMP.format(p=1) +
     "    if (s == 1 && nch > 1) " + _SSTAMP.format(p=2)),
    ("    if (ch == nch - 1) {  // the tile's row scores, then its partial\n",
     "    if (ch == nch - 1) {  // the tile's row scores, then its partial\n"
     "      if (s / nch == 0) " + _SSTAMP.format(p=3)),
    ("        partial[t] = v;\n",
     "        partial[t] = v;\n        if (s / nch == 0) " +
     _SSTAMP.format(p=4)),
    ('  asm volatile("cp.async.wait_group 0;\\n" ::: "memory");\n',
     "  " + _SSTAMP.format(p=5) +
     '  asm volatile("cp.async.wait_group 0;\\n" ::: "memory");\n'),
    ("    if (s_last) *done = 0;  // for the next launch\n",
     "    if (s_last) *done = 0;  // for the next launch\n    " +
     _SSTAMP.format(p=6) + "    if (s_last) g_ssum[0] = clock64();\n"),
    ("    if (lane == 0) w_out[p] = v / (float)N;\n  }\n",
     "    if (lane == 0) w_out[p] = v / (float)N;\n  }\n"
     "  if (threadIdx.x == 0) g_ssum[1] = clock64();\n"),
    ("}  // namespace\n",
     "}  // namespace\nextern \"C\" int semantic_scores_stamps(long long* c) "
     "{\n  cudaError_t e = cudaMemcpyFromSymbol(c, g_sclk, sizeof(g_sclk));\n"
     "  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(c + 8 * 1024, g_ssum, "
     "sizeof(g_ssum));\n  return (int)e;\n}\n"),
]


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()


def build_all(jobs, build):
    """Compile ``[(name, source text)]`` in parallel; name -> CDLL."""
    nvcc = build.find_nvcc()
    procs = []
    for name, text in jobs:
        d = OUT / name
        d.mkdir(parents=True, exist_ok=True)
        src = d / "kernel.cu"
        src.write_text(text)
        procs.append((name, src, subprocess.Popen(
            [nvcc, *build.CFLAGS, "-shared", str(src), "-o",
             str(d / "kernel.so")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    libs, ptxas = {}, {}
    for name, src, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode:
            sys.exit(f"nvcc failed on variant {name}:\n{out}")
        ptxas[name] = [ln.strip() for ln in out.splitlines()
                       if "registers" in ln or "spill" in ln]
        libs[name] = ctypes.CDLL(str(src.with_name("kernel.so")))
    return libs, ptxas


def variant_text(path: Path, subs) -> str:
    text = path.read_text()
    for old, new in subs:
        if isinstance(old, tuple):  # (start, end): swap the span between
            i, j = text.find(old[0]), text.find(old[1])
            if i < 0 or j < i:
                sys.exit(f"{path.name}: variant span not found: {old!r}")
            text = text[:i] + new + text[j:]
            continue
        if old not in text:
            sys.exit(f"{path.name}: variant text not found: {old!r}")
        text = text.replace(old, new)
    return text


def sa_variants(libs, res, magnn, h, times, stream, stamps, old_scores, cs,
                build, tsem) -> None:
    """``semantic_scores`` and ``semantic_combine`` variants on MAGNN/imdb's
    stacked NA output: each against the port's kernel (bitwise) or the
    plain version (``TOL_SCORES``), then timed cold and warm; with
    ``stamps`` the kept scores kernel's phases in ``clock64`` cycles."""
    import numpy as np
    import torch

    dev = h[magnn.plan.target].device
    z = torch.stack(magnn.executor.na(magnn.params, magnn.batch, h))
    sem = magnn.params["sem"]
    sa = (z, sem["W"], sem["b"], sem["q"])
    p, n, d = z.shape
    beta = torch.softmax(tsem.semantic_scores(*sa), 0)

    def scores_call(name):
        lib = libs[name]
        part = torch.zeros(p * -(-n // 32), device=dev)  # 32- or 64-row tiles
        done = torch.zeros(1, dtype=torch.int32, device=dev)
        out = torch.empty(p, device=dev)
        ptrs = [x.data_ptr() for x in sa] + [part.data_ptr()]
        ptrs += [] if name == "scores parent" and old_scores \
            else [done.data_ptr()]
        ptrs.append(out.data_ptr())

        def run():
            build.check(lib.semantic_scores_launch(
                *ptrs, p, n, d, sem["W"].shape[1], stream()),
                f"{name} variant")
            return out
        return run

    def combine_call(name):
        lib = libs[name]
        out = torch.empty((n, d), device=dev)

        def run():
            build.check(lib.semantic_combine_launch(
                z.data_ptr(), beta.data_ptr(), out.data_ptr(), p, n * d,
                stream()), f"{name} variant")
            return out
        return run

    plain = tsem.semantic_scores_plain(*sa)
    groups = (("scores", "semantic_scores", scores_call,
               tsem.semantic_scores(*sa), ("rows8", "rows4", "tc",
                                           "parent", "acc0")),
              ("combine", "semantic_combine", combine_call,
               tsem.semantic_combine(z, beta), ()))
    for group, key, call, want, reordered in groups:
        names = [nm for nm in libs if nm.startswith(group + " ")
                 and not nm.startswith(group + " stamps")]
        for name in names:
            if name.endswith("launch_only") or " diag_" in name:
                continue  # timing only
            got = call(name)().clone()
            got2 = call(name)()
            torch.cuda.synchronize()
            if name.split(" ", 1)[1] in reordered:
                res["max_abs_err"][name] = cs.max_err(got, plain)
                res["equal"][name] = bool(
                    cs.close(got, plain, **cs.TOL_SCORES) and
                    torch.equal(got, got2))
            else:
                res["equal"][name] = bool(torch.equal(got, want) and
                                          torch.equal(got2, want))
        for name in names:
            cold, warm = times(call(name))
            res[key][name] = [cold, warm]
            print(f"  {name}: {cold * 1e3:.2f} us cold, {warm * 1e3:.2f} us "
                  f"warm")

    out = {}
    for stamp_name in [nm for nm in libs if nm.startswith("scores stamps")]:
        lib = libs[stamp_name]
        lib.semantic_scores_stamps.argtypes = [_P]
        lib.semantic_scores_stamps.restype = _I
        clk = (ctypes.c_longlong * (8 * 1024 + 2))()
        fn = scores_call(stamp_name)
        for mode in ("cold", "warm"):
            fn()
            torch.cuda.synchronize()
            if mode == "cold":
                torch.empty(16 * 2 ** 20, device=dev).sum()
            fn()
            torch.cuda.synchronize()
            build.check(lib.semantic_scores_stamps(clk), "stamps")
            a = np.ctypeslib.as_array(clk)
            blocks = min(1024, p * -(-n // tsem.tile_rows(z, sem["W"])),
                         torch.cuda.get_device_properties(
                             dev).multi_processor_count)
            c = a[:8 * 1024].reshape(8, 1024)[:7, :blocks].astype(np.float64)
            phase = np.diff(c, axis=0)
            total = c[6] - c[0]
            out[f"{stamp_name} {mode}"] = {
                "median": [float(np.median(x)) for x in phase],
                "max": [float(x.max()) for x in phase],
                "block_median": float(np.median(total)),
                "block_max": float(total.max()),
                "last_block_sum": float(a[8 * 1024 + 1] - a[8 * 1024])}
            print(f"  {stamp_name} {mode} (cycles, median / max over "
                  f"{blocks} blocks): " + ", ".join(
                      f"{nm} {np.median(x):.0f} / {x.max():.0f}"
                      for nm, x in zip(SCORES_STAMP_NAMES, phase)) +
                  f"; a block {np.median(total):.0f} / {total.max():.0f}; "
                  f"the last block's sum {a[8 * 1024 + 1] - a[8 * 1024]:.0f}")
    if out:
        res["scores_stamps"] = out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", metavar="ROOT")
    ap.add_argument("--stamps", action="store_true")
    ap.add_argument("--only", nargs="+", default=list(GROUPS),
                    choices=GROUPS)
    args = ap.parse_args()
    groups = set(args.only)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("no CUDA device: this script measures a GPU")
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    import chip_smoke as cs
    from repro_torch.configs.base import HGNNConfig
    from repro_torch.core import metapath as mp
    from repro_torch.data.synthetic import make_dataset
    from repro_torch.kernels import build
    from repro_torch.kernels import feature_cache as tfc
    from repro_torch.kernels import segment_spmm as tspmm
    from repro_torch.kernels import semantic_attn as tsem
    from repro_torch.launch.serve import build_hgnn_infer

    card = card_line()
    print(card)
    csrc = build.CSRC
    jobs = []
    for group, table, src, stamps in (
            ("spmm", SPMM, "segment_spmm.cu", STAMPS),
            ("gather", GATHER, "feature_cache.cu", None),
            ("scores", SCORES, "semantic_scores.cu", SCORES_STAMPS),
            ("combine", COMBINE, "semantic_combine.cu", None)):
        if group not in groups:
            continue
        jobs += [(f"{group} {k}", variant_text(csrc / src, v))
                 for k, v in table.items()]
        if args.stamps and stamps:
            jobs.append((f"{group} stamps", variant_text(csrc / src, stamps)))
        if args.stamps and group == "scores":  # and without staging W
            jobs.append(("scores stamps diag_no_w", variant_text(
                csrc / src, stamps + SCORES["diag_no_w"])))
        if args.parent:
            pc = Path(args.parent).resolve() / "src/repro_torch/kernels/csrc"
            jobs.append((f"{group} parent", (pc / src).read_text()))
    texts = dict(jobs)
    old_gather = "gather parent" in texts and "int vec, void* stream" in \
        re.sub(r"\s+", " ", texts["gather parent"])
    # the two-launch scores kernel takes no last-block counter
    old_scores = "scores parent" in texts and "int* done" not in \
        texts["scores parent"]
    libs, ptxas = build_all([(n.replace(" ", "_"), t) for n, t in jobs],
                            build)
    libs = {n: libs[n.replace(" ", "_")] for n, _ in jobs}
    ptxas = {n: ptxas[n.replace(" ", "_")] for n, _ in jobs}
    for name, lib in libs.items():
        if name.startswith("spmm"):
            lib.segment_spmm_launch.argtypes = [_P] * 4 + [_I] * 4 + [_P]
            lib.segment_spmm_launch.restype = _I
        elif name.startswith("scores"):
            lib.semantic_scores_launch.argtypes = (
                [_P] * (6 if name == "scores parent" and old_scores else 7) +
                [_I] * 4 + [_P])
            lib.semantic_scores_launch.restype = _I
        elif name.startswith("combine"):
            lib.semantic_combine_launch.argtypes = [_P] * 3 + [_I, _L, _P]
            lib.semantic_combine_launch.restype = _I
        elif name == "gather parent" and old_gather:
            lib.cached_gather_launch.argtypes = ([_P] * 4 + [_I] * 3 +
                                                 [_L] * 4 + [_I, _P])
            lib.cached_gather_launch.restype = _I
        else:
            lib.cached_gather_launch.argtypes = ([_P] * 4 + [_I] * 3 +
                                                 [_L] * 5 + [_P])
            lib.cached_gather_launch.restype = _I
    for name, lines in ptxas.items():
        print(f"  ptxas {name}: {' | '.join(lines)}")

    dev = torch.device("cuda")
    hg = make_dataset("imdb")
    if "spmm" in groups:
        rgcn = build_hgnn_infer(HGNNConfig(model="rgcn", dataset="imdb",
                                           fused=True, use_pallas=True), hg,
                                dev)
    magnn = build_hgnn_infer(HGNNConfig(model="magnn", dataset="imdb",
                                        use_pallas=True, cache_rows=256),
                             hg, dev)
    flush = torch.empty(16 * 2 ** 20, dtype=torch.float32, device=dev)

    def stream():
        return torch.cuda.current_stream(dev).cuda_stream

    def spmm_call(lib, h_src, nbr, mask):
        out = torch.empty((nbr.shape[0], h_src.shape[1]), device=dev)

        def run():
            err = lib.segment_spmm_launch(
                h_src.data_ptr(), nbr.data_ptr(), mask.data_ptr(),
                out.data_ptr(), nbr.shape[0], nbr.shape[1], h_src.shape[1],
                1, stream())
            build.check(err, "segment_spmm variant")
            return out
        return run

    def gather_call(name, table, hot, idx):
        lib = libs[name]
        (n, d), (rows, cols) = table.shape, idx.shape
        out = torch.empty((rows, cols, d), device=dev)

        def run():
            if name == "gather parent" and old_gather:
                cache = table.index_select(0, hot)  # as its wrapper fills
                err = lib.cached_gather_launch(
                    table.data_ptr(), cache.data_ptr(), idx.data_ptr(),
                    out.data_ptr(), n, hot.shape[0], d, rows, cols,
                    *idx.stride(), 1, stream())
            else:
                err = lib.cached_gather_launch(
                    table.data_ptr(), hot.data_ptr(), idx.data_ptr(),
                    out.data_ptr(), n, hot.shape[0], d, hot.stride(0), rows,
                    cols, *idx.stride(), stream())
            build.check(err, "cached_gather variant")
            return out
        return run

    def times(fn):
        return cs.time_ms(fn, 50, flush), cs.time_ms(fn, 50)

    res = {"card": card, "ptxas": ptxas, "segment_spmm": {},
           "cached_gather": {}, "semantic_scores": {},
           "semantic_combine": {}, "reference": {}, "equal": {},
           "max_abs_err": {}}
    spmm_names = [n for n in libs if n.startswith("spmm")
                  and n != "spmm stamps"]
    gather_names = [n for n in libs if n.startswith("gather")]
    with torch.inference_mode():
        if "spmm" in groups:
            h = rgcn.executor.fp(rgcn.params, rgcn.batch)
            rels = [("|".join(k), h[k[0]], *rgcn.batch["rels"][k])
                    for k in sorted(rgcn.batch["rels"])]
            cases = list(rels)
            for tag, h_src, nbr, mask in rels:
                bk = mp.bucket_padded(mp.PaddedSubgraph(
                    nbr.cpu().numpy(), mask.cpu().numpy(), []), 3)
                cases += [(f"{tag} K=64 bucket", h_src,
                           torch.as_tensor(b_nbr, device=dev),
                           torch.as_tensor(b_mask, device=dev))
                          for b_nbr, b_mask in zip(bk.nbr, bk.mask)
                          if b_nbr.shape[1] == 64]
            for tag, h_src, nbr, mask in cases:
                want = tspmm.segment_spmm(h_src, nbr, mask)
                for name in spmm_names:
                    if name == "spmm launch_only":
                        continue
                    got = spmm_call(libs[name], h_src, nbr, mask)()
                    res["equal"][f"{name} {tag}"] = bool(
                        torch.equal(got, want))
                for name in spmm_names:
                    cold, warm = times(spmm_call(libs[name], h_src, nbr, mask))
                    res["segment_spmm"][f"{name} {tag}"] = [cold, warm]
                    print(f"  {name} {tag}: {cold * 1e3:.2f} us cold, "
                          f"{warm * 1e3:.2f} us warm")
            for name in spmm_names:
                calls = [spmm_call(libs[name], *c[1:]) for c in rels]

                def layer(calls=calls):
                    for fn in calls:
                        fn()
                cold, warm = times(layer)
                res["segment_spmm"][f"{name} layer"] = [cold, warm]
                print(f"  {name} layer (4 launches): {cold * 1e3:.2f} us "
                      f"cold, {warm * 1e3:.2f} us warm")

            if args.stamps:
                lib = libs["spmm stamps"]
                lib.segment_spmm_stamps.argtypes = [_P]
                lib.segment_spmm_stamps.restype = _I
                clk = (ctypes.c_longlong * (8 * 4096))()
                for tag, h_src, nbr, mask in cases:
                    fn = spmm_call(lib, h_src, nbr, mask)
                    fn()
                    flush.sum()
                    fn()
                    torch.cuda.synchronize()
                    build.check(lib.segment_spmm_stamps(clk), "stamps")
                    blocks = -(-nbr.shape[0] // tspmm.ROWS)
                    c = np.ctypeslib.as_array(clk).reshape(8, 4096)[:, :blocks]
                    phase = np.diff(c.astype(np.float64), axis=0)
                    # blocks with no live slot skip the ring: no chunk stamp
                    live = (mask != 0).reshape(-1).cpu().numpy()
                    pad = blocks * tspmm.ROWS * nbr.shape[1] - live.size
                    ok = np.concatenate([live, np.zeros(pad, bool)]).reshape(
                        blocks, -1).any(axis=1)
                    phase = phase[:, ok]
                    total = (c[7] - c[0])[ok]
                    res.setdefault("stamps", {})[tag] = {
                        "median": [float(np.median(p)) for p in phase],
                        "max": [float(p.max()) for p in phase],
                        "block_median": float(np.median(total)),
                        "block_max": float(total.max())}
                    print(f"  stamps {tag} (cycles, median / max over "
                          f"{int(ok.sum())} blocks): " + ", ".join(
                              f"{nm} {np.median(p):.0f} / {p.max():.0f}"
                              for nm, p in zip(STAMP_NAMES, phase)) +
                          f"; a block {np.median(total):.0f} / "
                          f"{total.max():.0f}")

        hm = magnn.executor.fp(magnn.params, magnn.batch)
        if "gather" in groups:
            hot = magnn.batch["residency"]["hot"]
            gathers = [(hm[ty], hot[ty], nodes[:, :, j])
                       for (nodes, _), types in zip(magnn.batch["instances"],
                                                    magnn.plan.metapaths)
                       for j, ty in enumerate(types)]
            for g in gathers:
                want = tfc.cached_gather(*g)
                for name in gather_names:
                    key = f"{name} layer"
                    res["equal"][key] = res["equal"].get(key, True) and bool(
                        torch.equal(gather_call(name, *g)(), want))
            out = torch.empty((4278 * 16, 64), device=dev)
            src = torch.randn((4278 * 16, 64), device=dev)
            for name, fn in (("fill_", lambda: out.fill_(1.0)),
                             ("copy_", lambda: out.copy_(src))):
                cold, warm = times(fn)
                res["reference"][f"{name} 17.5 MB"] = [cold, warm]
                print(f"  {name} of one position's output (17.5 MB): "
                      f"{cold * 1e3:.2f} us cold, {warm * 1e3:.2f} us warm")
            for name in gather_names:
                calls = [gather_call(name, *g) for g in gathers]

                def layer(calls=calls):
                    for fn in calls:
                        fn()
                cold, warm = times(layer)
                one = cs.time_ms(calls[0], 50, flush)
                res["cached_gather"][f"{name} layer"] = [cold, warm]
                res["cached_gather"][f"{name} one position"] = [one, None]
                print(f"  {name} layer (6 launches): {cold * 1e3:.2f} us "
                      f"cold, {warm * 1e3:.2f} us warm; one position "
                      f"{one * 1e3:.2f} us cold")
        if groups & {"scores", "combine"}:
            sa_variants(libs, res, magnn, hm, times, stream, args.stamps,
                        old_scores, cs, build, tsem)
    bad = sorted(k for k, v in res["equal"].items() if not v)
    print(f"  variants bitwise equal to the port's kernels: "
          f"{'all' if not bad else 'not ' + ', '.join(bad)}")
    print(card)
    print(json.dumps(res))
    if bad:
        sys.exit(1)


if __name__ == "__main__":
    main()
