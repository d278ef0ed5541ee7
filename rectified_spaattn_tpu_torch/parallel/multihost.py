"""Prompt-level data parallelism for batch evaluation (port of
rectified_spaattn_tpu/parallel/multihost.py).

The reference's multi-GPU eval is ``ProcessPoolExecutor`` over
``prompt_list[i::num_gpus]`` with one pipeline per process (reference:
eval/video/experiments/multigpu_hunyuan.py:287-298).  The JAX package runs
one process per host, its tp on that host's devices and its shard the
process index.  The port runs one process per GPU: the world is a (dp, tp)
mesh (parallel.make_mesh), each dp slice evaluates
``prompts[dp_rank::dp]`` with a pipeline sharded over its tp group, and
only tp rank 0 of a slice writes files.
"""

from __future__ import annotations

import os
from typing import Sequence

import torch
import torch.distributed as dist


def shard_prompts(prompts: Sequence, shard_index: int | None = None,
                  num_shards: int | None = None) -> list:
    """Round-robin prompt shard for this worker (the reference's
    interleaving, prompt_list[i::num_gpus]).  The defaults are the global
    rank and world size of an initialised torch.distributed (JAX's
    process_index / process_count), otherwise 0 and 1."""
    live = dist.is_available() and dist.is_initialized()
    if shard_index is None:
        shard_index = dist.get_rank() if live else 0
    if num_shards is None:
        num_shards = dist.get_world_size() if live else 1
    return list(prompts)[shard_index::num_shards]


def launch_eval(argv=None):
    """Multi-process batch-eval launcher.

        python -m rectified_spaattn_tpu_torch.parallel.multihost \\
            [--coordinator_address host:port --num_processes N \\
             --process_id I | --distributed] <run_eval args...>

    The flags are the JAX launcher's: the coordinator triple initialises
    torch.distributed over ``tcp://host:port``; ``--distributed`` reads
    torchrun's environment (``env://``); with neither, the explicit ids
    stand in and no group is made.  Under a group the world becomes a
    ``make_mesh(tp=--tp)``, and each dp slice evaluates its
    ``prompt_list[dp_rank::dp]`` shard through eval.run_eval with
    --shard_index / --num_shards injected.  The backend is NCCL only when
    tp > 1 on the card; at tp = 1 no tensor crosses ranks, so it is gloo
    (several ranks may then share one card).  Returns (shard index,
    shard count)."""
    import argparse

    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--coordinator_address", default=None)
    ap.add_argument("--num_processes", type=int, default=None)
    ap.add_argument("--process_id", type=int, default=None)
    ap.add_argument("--distributed", action="store_true",
                    help="initialise from torchrun's environment (env://)")
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    args, rest = ap.parse_known_args(argv)

    from ..eval import run_eval
    from .mesh import init_distributed, local_device, make_mesh

    grouped = bool(args.coordinator_address or args.distributed)
    mesh, owned = None, False
    if grouped:
        if args.coordinator_address:
            rank = args.process_id
            init = dict(init_method=f"tcp://{args.coordinator_address}",
                        world_size=args.num_processes, rank=rank)
        else:
            rank, init = int(os.environ.get("RANK", 0)), {}
        device = str(local_device(args.device, rank))
        backend = ("nccl" if torch.device(device).type == "cuda"
                   and args.tp > 1 else "gloo")
        owned = not dist.is_initialized()
        if owned:
            init_distributed(device, backend=backend, **init)
        mesh = make_mesh(tp=args.tp)
        index, count = mesh.group("dp").rank, mesh.shape["dp"]
    else:
        # explicit ids stand in for the runtime, as in JAX
        device = args.device
        index = args.process_id if args.process_id is not None else 0
        count = args.num_processes if args.num_processes is not None else 1
    try:
        run_eval.main(rest + ["--tp", str(args.tp), "--device", device,
                              "--shard_index", str(index),
                              "--num_shards", str(count)], mesh=mesh)
    finally:
        if owned:
            dist.destroy_process_group()
    return index, count


if __name__ == "__main__":
    launch_eval()
