"""Utilities of the port: completion-forced timing (``benchmarking``),
program spans and the profiler capture (``timing``), checkpoint restore
(``ckpt``), run analysis (``analyze``) and what the trainer's and the
imputer's CUDA graphs share (``graphs``)."""
