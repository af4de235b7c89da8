"""Utilities of the port: completion-forced timing (``benchmarking``),
phase timers and the profiler capture (``timing``), checkpoint restore
(``ckpt``) and run analysis (``analyze``)."""
