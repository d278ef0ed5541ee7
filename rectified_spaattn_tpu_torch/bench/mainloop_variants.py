"""Ablations of the Hopper attention mainloop that K1/K1s, K2 and K3 share
(csrc/hopper_attn.cuh) and of K1q's kernel on its parts
(hopper_attn_q_kernel, csrc/block_sparse.cu), timed at the main path's
shapes by kernel_ab.py.

    python -m rectified_spaattn_tpu_torch.bench.mainloop_variants \\
        [--variants stages3,pingpong,compute,load,convert] [--reps 3]

Each variant is this package copied under ``outputs/mainloop_variants/``
(git-ignored) with its edits to its copies of those two files (compute
and load edit both kernels, the others one):

  stages3   a third ring stage (224 KB of shared memory, still one CTA an
            SM);
  pingpong  the two consumer warpgroups take turns at the tensor cores
            (named barriers 3 and 4 around each unit's S = Q K^T issue),
            so that one's softmax can run beside the other's products;
  compute   no K/V copies: the producer completes each stage's barrier
            without a copy, so the consumers compute
            on whatever the ring holds (the output is garbage; only its
            time counts; kernels/variants.py's S3a and S2 ``compute``
            measure the same with a defined tile);
  load      no products and no softmax: the consumers wait for each unit
            and hand its stage back (the output is zero; S3a / S2 ``dma``
            measure the same, adding one K row per chunk);
  convert   K1q only: the converter threads hand each staged unit on
            without converting it (the output is garbage).

kernel_ab.py then times this package and each copy in turns (base, every
variant, every variant again in reverse, base), one process each, and the
last line is one JSON object {label: {kernel: ms}} with the device.  An
edit whose text no longer matches the header raises: the ablations follow
the mainloop as it is.  Needs a CUDA GPU and nvcc (kernel_ab.py's).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(PKG)
HEADER = os.path.join("csrc", "hopper_attn.cuh")
K1Q = os.path.join("csrc", "block_sparse.cu")

EDITS = {
    "stages3": [(HEADER, "constexpr int HA_STAGES = 2;",
                 "constexpr int HA_STAGES = 3;")],
    "pingpong": [
        (HEADER, "__device__ __forceinline__ void wg_sync(int wg) {",
         "__device__ __forceinline__ void turn_wait(int wg) {\n"
         "  asm volatile(\"bar.sync %0, 256;\\n\" :: \"r\"(3 + wg) : "
         "\"memory\");\n}\n"
         "__device__ __forceinline__ void turn_pass(int wg) {\n"
         "  asm volatile(\"bar.arrive %0, 256;\\n\" :: \"r\"(4 - wg) : "
         "\"memory\");\n}\n"
         "__device__ __forceinline__ void wg_sync(int wg) {"),
        (HEADER, "    int st = 0;\n    uint32_t ph = 0, qph = 0;\n"
         "    for (int t = P::first(p); t < P::count(p); t += P::stride(p)) {"
         "\n      const typename P::Tile c = P::tile(p, t);\n"
         "      if constexpr (F32) {",
         "    if (f.wg == 1) turn_pass(1);\n"
         "    int st = 0;\n    uint32_t ph = 0, qph = 0;\n"
         "    for (int t = P::first(p); t < P::count(p); t += P::stride(p)) {"
         "\n      const typename P::Tile c = P::tile(p, t);\n"
         "      if constexpr (F32) {"),
        (HEADER, "        float s[64];\n        wgmma_fence();",
         "        float s[64];\n        turn_wait(f.wg);\n"
         "        wgmma_fence();"),
        (HEADER, "        wgmma_commit();\n"
         "        un = P::next(p, c, u + 1);   // its loads overlap the "
         "products\n",
         "        wgmma_commit();\n        turn_pass(f.wg);\n"
         "        un = P::next(p, c, u + 1);\n"),
    ],
    "compute": [(HEADER, "            mbar_expect_tx(&full[st], P::COPY_BYTES);\n"
                 "            unsigned char* dst = ring + st * STAGE;\n"
                 "            P::copy(p, c, row, dst, &full[st]);",
                 "            mbar_expect_tx(&full[st], 0);\n"
                 "            (void)row;"),
                (K1Q, "        mbar_expect_tx(&sfull[ss_next], L::STAGE8);\n"
                 "        stage_load<MODE, D>(stg + ss_next * L::STAGE8, "
                 "&p.tmkv, row_next,\n                            "
                 "&sfull[ss_next]);",
                 "        mbar_expect_tx(&sfull[ss_next], 0);"),
                (K1Q, "        mbar_expect_tx(&full[st], HA_TILE8);\n"
                 "        tma_load(ring + st * L::RING, &p.tmkv, 0, row, "
                 "&full[st]);",
                 "        mbar_expect_tx(&full[st], 0);")],
    "load": [(HEADER, "        mbar_wait_or_trap(&full[F32 ? 2 * st : st], ph);\n"
              "        const unsigned char* ks = ring + st * STAGE;",
              "        mbar_wait_or_trap(&full[F32 ? 2 * st : st], ph);\n"
              "        if (u >= 0) {\n          (void)win;\n"
              "          un = P::next(p, c, u + 1);\n"
              "          if (un >= c.u1) mbar_arrive(q_empty);\n"
              "          mbar_arrive(&empty[st]);\n"
              "          if (++st == NS) {\n            st = 0;\n"
              "            ph ^= 1;\n          }\n          continue;\n"
              "        }\n"
              "        const unsigned char* ks = ring + st * STAGE;"),
             (K1Q, "      mbar_wait_or_trap(&full[st], ph);\n"
              "      const unsigned char* kst = ring + st * L::RING;",
              "      mbar_wait_or_trap(&full[st], ph);\n"
              "      if (n >= 0) {\n        (void)win;\n        (void)ks;\n"
              "        (void)vs;\n        mbar_arrive(&empty[st]);\n"
              "        if (++st == HA_STAGES) {\n          st = 0;\n"
              "          ph ^= 1;\n        }\n        continue;\n      }\n"
              "      const unsigned char* kst = ring + st * L::RING;")],
    "convert": [(K1Q, "        if (MODE == MODE_INT8) convert_tile<V16>(dst, "
                 "src, ci);\n"
                 "        convert_tile<V16>(dst + L::RING_K, src + L::STAGE8 "
                 "- HA_TILE8, ci);",
                 "        (void)dst;\n        (void)src;")],
}


def make_copy(name: str, out_dir: str) -> str:
    """This package copied to ``out_dir/name`` (without its build outputs)
    with variant ``name``'s edits applied; returns the copy's root."""
    root = os.path.join(out_dir, name)
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(PKG, os.path.join(root, os.path.basename(PKG)),
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    for rel, old, new in EDITS[name]:
        path = os.path.join(root, os.path.basename(PKG), rel)
        with open(path) as f:
            src = f.read()
        if src.count(old) != 1:
            raise ValueError(f"variant {name}: its edit does not match "
                             f"{rel} once")
        with open(path, "w") as f:
            f.write(src.replace(old, new))
    return root


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", default=",".join(EDITS))
    ap.add_argument("--reps", type=int, default=3)
    a = ap.parse_args(argv)
    names = a.variants.split(",")
    out_dir = os.path.join(ROOT, "outputs", "mainloop_variants")
    roots = {"base": ROOT, **{n: make_copy(n, out_dir) for n in names}}
    order = ["base", *names, *reversed(names), "base"]
    res: dict = {}
    for label in order:
        proc = subprocess.run(
            [sys.executable, os.path.join(ROOT, "kernel_ab.py"), "--root",
             roots[label], "--label", label, "--reps", str(a.reps)],
            capture_output=True, text=True, check=True)
        line = json.loads(proc.stdout.strip().splitlines()[-1])
        print(json.dumps(line), flush=True)
        res.setdefault("nvidia_smi", line["nvidia_smi"])
        res.setdefault(label, []).append(
            {k: v for k, v in line.items()
             if k not in ("label", "root", "nvidia_smi")})
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
