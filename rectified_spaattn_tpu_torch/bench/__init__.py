"""The port's benchmarks (ports of bench.py and the kernel-variant scripts
of scripts/), each run as ``python -m rectified_spaattn_tpu_torch.bench.<name>``
on a card, or with ``--device cpu --small`` as a rehearsal of the plain
versions:

- ``headline``: the sparse site against the windowed dense at the
  HunyuanVideo operating point (bench.py);
- ``kernelvars``: K1's ablations, S3 (scripts/bench_kernelvars.py);
- ``groupedvars``: K2's ablations, S2 (scripts/bench_groupedvars.py);

and what they share: ``inputs`` (the input makers) and ``common`` (the
operating point, timing).
"""
