"""PyTorch/CUDA port of the C3O reproduction (``repro``): the same paper
loop — shared runtime data, per-machine runtime predictors chosen by
leave-one-out CV, confidence-bounded cluster choice, validated
contributions — on an explicit ``device`` ("cuda" unless the caller asks
for "cpu"), with GBM-ensemble inference as a hand-written CUDA kernel."""
