"""Utilities of the port: completion-forced timing (``benchmarking``),
program spans and the profiler capture (``timing``), checkpoint restore
(``ckpt``) and run analysis (``analyze``)."""
