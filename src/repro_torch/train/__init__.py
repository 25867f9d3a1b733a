"""Training of the LM (port of ``repro/train``): optimizers, the train
step, checkpoints and the elastic helpers."""
