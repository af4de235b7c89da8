"""The benchmark of ``rag_snvbert_tpu_torch`` on one H100: ``python -m
benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
(``README.md``)."""
