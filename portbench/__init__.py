"""The benchmark of ``voicemap_tpu_torch`` on the H100: ``python3 -m
portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
(see ``run.py``). It measures the port only; nothing it runs imports JAX or
the JAX package."""
