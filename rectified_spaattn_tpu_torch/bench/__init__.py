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

the diagnostic benches, the same shape (``run`` / ``main``), at the
HunyuanVideo point (115,200 + 256 tokens, 24 x 128, sa_drop_rate 0.8,
p_remain 0.3) unless said:

- ``planstages``: each stage of the plan build alone (host, CUDA-event
  and profiled kernel ms) beside the whole plan, also at the CogVideoX
  site (``--grid 6,48,85 --heads 48 --head_dim 64 --drop 0.85 --tlen
  226``) (scripts/bench_planstages.py, bench_planstages2.py);
- ``planopts``: top-p variants A / B / C, the index sort, mask -> indices
  by sort, scatter and int16 sort (scripts/bench_planopts.py,
  bench_mask2idx.py);
- ``grouped``: the site at group_rows 1, 2, 4, 8 on model-statistics
  masks, with the masks' union growth (scripts/bench_grouped.py);
- ``groupfull``: the site at G = 1 and 2 on bench.py's smooth inputs
  (scripts/bench_groupfull.py);
- ``runstats``: the index lists' contiguous-run statistics
  (scripts/exp_runstats.py);
- ``coalesce``: site, plan and K1 alone on peaked and random inputs
  (scripts/bench_coalesce.py);
- ``dense``: K3 against the windowed dense at block_m 256 / 512 / 1024
  (scripts/bench_dense.py);
- ``kernel``: K1 against K3 on a synthetic mask (scripts/bench_kernel.py);
- ``fullpath``: the site on iid inputs (scripts/bench_fullpath.py);
- ``ab_randreg``: the random-regime site of one checkout, ``--root`` in
  its own process (scripts/ab_randreg.py);

and what they share: ``inputs`` (the input makers), ``common`` (the
operating point, timing, ``kernel_ms`` / ``device_ms`` from profiler
traces) and ``e2e_weights`` (the benches' random trees, drawn leaf by
leaf as the scripts draw them, and smooth latents).

Each runs on the card unless ``--device cpu`` is given;
``--device cpu --small`` is a rehearsal of the plain versions at a tiny
size (calibrate_teacache: ``--small`` runs 10 steps).
"""
