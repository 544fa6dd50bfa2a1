"""Training of the LM stack on one device: data, optimizers, the train step
and checkpoints (port of ``repro/train``)."""
