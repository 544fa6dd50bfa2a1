"""The LM stack of the port: the dense decoder and its attention layers,
routed through the hand-written attention kernels."""
