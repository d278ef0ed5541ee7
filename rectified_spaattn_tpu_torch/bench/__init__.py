"""The port's benchmarks (ports of bench.py and the kernel-variant scripts
of scripts/), each run as ``python -m rectified_spaattn_tpu_torch.bench.<name>``
on a card, or with ``--device cpu --small`` as a rehearsal of the plain
versions:

- ``headline``: the sparse site against the windowed dense at the
  HunyuanVideo operating point (bench.py);
- ``kernelvars``: K1's ablations, S3 (scripts/bench_kernelvars.py);
- ``groupedvars``: K2's ablations, S2 (scripts/bench_groupedvars.py);

the end-to-end A/B benches, with the scripts' flags and defaults, each a
``run(...)`` that returns a dict and a ``main(argv)`` that prints it as
one JSON line:

- ``e2e``: the HunyuanVideo step, sparse against dense, at full width and
  any depth (scripts/bench_e2e.py), e.g. ``--dual 20 --single 40
  --scan_blocks --quant 4 --p_remain 0.05 --steps 1``;
- ``e2e_wan``: Wan2.1 T2V / I2V, Wan2.2 A14B and TI2V, with TeaCache
  (scripts/bench_e2e_wan.py), e.g. ``--blocks 8 --teacache
  --signal_scale 0.0979``;
- ``e2e_cog``: CogVideoX1.5-5B at full depth (scripts/bench_e2e_cog.py);
- ``e2e_flux``: Flux.1-dev at 4096^2 (scripts/bench_e2e_flux.py);
- ``fidelity_gate``: the sparse site against the windowed dense at one
  point: rel-L1, PSNR, cosine, RMSE (scripts/fidelity_gate.py);
- ``longctx``: the site at 2x / 2.5x the reference's context
  (scripts/bench_longctx.py);
- ``ab_eval``: the Hunyuan pipeline dense then sparse, diff metrics
  (scripts/ab_eval.py);
- ``calibrate_teacache``: the random-weight TeaCache signal scales
  through the port's CLI (scripts/calibrate_teacache.py; the script's
  setting is ``--device cpu``);

and what they share: ``inputs`` (the input makers), ``common`` (the
operating point, timing) and ``e2e_weights`` (the benches' random trees,
drawn leaf by leaf as the scripts draw them, and smooth latents).

Each runs on the card unless ``--device cpu`` is given;
``--device cpu --small`` is a rehearsal of the plain versions at a tiny
size (calibrate_teacache: ``--small`` runs 10 steps).
"""
