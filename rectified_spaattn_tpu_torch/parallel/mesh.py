"""Process groups for multi-device execution (port of
rectified_spaattn_tpu/parallel/mesh.py).

The JAX package builds a named (dp, tp, sp) device mesh and lets XLA insert
the collectives.  The port names one group per mesh axis and calls the
collectives itself.  Two transports run the same per-rank code:

  ``DistGroup``       a ``torch.distributed`` process group, one rank per
                      process: NCCL for CUDA tensors, gloo for CPU tensors
                      (``init_distributed`` picks the backend from the
                      device).  The all-gather is
                      ``all_gather_into_tensor``, the ring shift one
                      ``batch_isend_irecv`` to rank + 1 / from rank - 1.
  ``InProcessGroup``  n ranks in ONE process on one device: the per-rank
                      code runs for ranks 0..n-1 in turn, its all-gather
                      is a concatenation and its ring shift a list
                      rotation.  It is how one card, or one test process,
                      runs an sp = 4 ring (the counterpart of the JAX
                      tests' ``--xla_force_host_platform_device_count=8``).
                      It is used only where the caller builds it.

Per-rank code that needs a collective is a generator that yields the
request (``AllGather``, ``Shift``) and receives the result.  Both groups
have the same contract: ``group.run(bodies)`` takes one generator for each
rank of ``group.local_ranks`` (this process's rank for a ``DistGroup``,
every rank for an ``InProcessGroup``) and returns their return values in
that order.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

AXES = ("dp", "tp", "sp")


@dataclasses.dataclass
class AllGather:
    """Concatenate each rank's ``tensors`` along ``dim`` in rank order;
    every rank receives the tuple of concatenations."""
    tensors: tuple
    dim: int


@dataclasses.dataclass
class Shift:
    """Send ``tensor`` to rank + 1 and receive rank - 1's (mod n)."""
    tensor: torch.Tensor


class DistGroup:
    """One ``torch.distributed`` process group (the default group when
    ``pg`` is None)."""

    def __init__(self, pg=None):
        self.pg = pg
        self.size = dist.get_world_size(pg)
        self.rank = dist.get_rank(pg)
        self.local_ranks = (self.rank,)

    def _global(self, rank: int) -> int:
        return rank if self.pg is None else dist.get_global_rank(self.pg,
                                                                 rank)

    def all_gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        x = t.movedim(dim, 0).contiguous()
        out = torch.empty((self.size * x.shape[0], *x.shape[1:]),
                          dtype=x.dtype, device=x.device)
        dist.all_gather_into_tensor(out, x, group=self.pg)
        # contiguous, as the in-process concatenation: both transports
        # then feed the same layouts to the ops that follow
        return out.movedim(0, dim).contiguous()

    def shift(self, t: torch.Tensor) -> torch.Tensor:
        t = t.contiguous()
        buf = torch.empty_like(t)
        nxt = self._global((self.rank + 1) % self.size)
        prv = self._global((self.rank - 1) % self.size)
        reqs = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, t, nxt, group=self.pg),
            dist.P2POp(dist.irecv, buf, prv, group=self.pg)])
        for r in reqs:
            r.wait()
        return buf

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum over the group, in place."""
        dist.all_reduce(t, group=self.pg)
        return t

    def run(self, bodies: list) -> list:
        """Drive the one body of this process (rank ``self.rank``) through
        its collectives; returns ``[its return value]``."""
        if len(bodies) != 1:
            raise ValueError(f"{len(bodies)} bodies for one local rank")
        body, result = bodies[0], None
        while True:
            try:
                req = body.send(result)
            except StopIteration as stop:
                return [stop.value]
            if isinstance(req, AllGather):
                result = tuple(self.all_gather(t, req.dim)
                               for t in req.tensors)
            elif isinstance(req, Shift):
                result = self.shift(req.tensor)
            else:
                raise TypeError(f"unknown collective {req!r}")


class InProcessGroup:
    """``size`` ranks run in turn in this process, on the device of the
    tensors they are given (see the module docstring)."""

    def __init__(self, size: int):
        if size < 1:
            raise ValueError(f"group size must be >= 1, got {size}")
        self.size = size
        self.local_ranks = tuple(range(size))

    def run(self, bodies: list) -> list:
        """Drive one generator per rank in lockstep; returns their return
        values in rank order.  Every rank must reach the same collectives
        in the same order."""
        if len(bodies) != self.size:
            raise ValueError(f"{len(bodies)} bodies for {self.size} ranks")
        results = [None] * self.size
        done = [None] * self.size
        while True:
            reqs = []
            for r, body in enumerate(bodies):
                try:
                    reqs.append(body.send(results[r]))
                except StopIteration as stop:
                    reqs.append(None)
                    done[r] = stop
            if all(d is not None for d in done):
                return [d.value for d in done]
            if any(d is not None for d in done):
                raise RuntimeError("ranks left the collective sequence at "
                                   "different points")
            kind = type(reqs[0])
            if any(type(q) is not kind for q in reqs):
                raise RuntimeError(f"ranks disagree on the collective: "
                                   f"{[type(q).__name__ for q in reqs]}")
            if kind is AllGather:
                cat = tuple(torch.cat([q.tensors[i] for q in reqs],
                                      dim=reqs[0].dim)
                            for i in range(len(reqs[0].tensors)))
                results = [cat] * self.size
            elif kind is Shift:
                results = [reqs[(r - 1) % self.size].tensor
                           for r in range(self.size)]
            else:
                raise TypeError(f"unknown collective {reqs[0]!r}")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Named process groups of a (dp, tp, sp) mesh; ``shape`` maps each
    axis to its size and ``groups`` each axis to this rank's group."""
    shape: dict
    groups: dict

    def group(self, axis: str):
        return self.groups[axis]


def init_distributed(device, *, init_method: Optional[str] = None,
                     world_size: Optional[int] = None,
                     rank: Optional[int] = None,
                     backend: Optional[str] = None, **kw) -> None:
    """``torch.distributed.init_process_group`` with the backend that
    matches ``device`` (NCCL for cuda, gloo for cpu) unless ``backend``
    names one.  Without arguments it reads torchrun's environment
    (``env://``); ``kw`` goes to ``init_process_group`` (e.g.
    ``timeout``)."""
    dev = torch.device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if dev.type == "cuda" and dev.index is not None:
        torch.cuda.set_device(dev)
    if world_size is not None:
        kw.update(world_size=world_size, rank=rank)
    dist.init_process_group(backend, init_method=init_method or "env://",
                            **kw)


def local_device(device: str = "cuda",
                 rank: Optional[int] = None) -> torch.device:
    """This process's device: cuda:LOCAL_RANK under torchrun; else, given
    the global ``rank`` of a group made without torchrun,
    cuda:(rank mod the card count), so that ranks spread over the host's
    cards and share them when there are fewer; else cuda:0.  The CPU
    when ``device`` is the CPU."""
    if torch.device(device).type != "cuda":
        return torch.device("cpu")
    if "LOCAL_RANK" in os.environ or rank is None:
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return torch.device("cuda", rank % max(torch.cuda.device_count(), 1))


def axis_groups(shape: dict) -> dict:
    """The rank lists of every group of each axis, for ranks laid out as
    ``arange(world).reshape(dp, tp, sp)`` (the JAX mesh's device
    layout)."""
    sizes = [shape[a] for a in AXES]
    ranks = np.arange(int(np.prod(sizes))).reshape(sizes)
    return {axis: np.moveaxis(ranks, a, -1).reshape(-1, sizes[a]).tolist()
            for a, axis in enumerate(AXES)}


def make_mesh(dp: Optional[int] = None, tp: Optional[int] = None,
              sp: int = 1) -> Mesh:
    """(dp, tp, sp) process groups over the initialised world (the JAX
    defaults: tp = min(world, 8) when dp is not given, the rest dp).
    Every rank must call this in the same order: ``new_group`` is
    collective."""
    n = dist.get_world_size()
    if tp is None:
        tp = min(n, 8) if dp is None else n // (dp * sp)
    if dp is None:
        dp = n // (tp * sp)
    if dp * tp * sp != n:
        raise ValueError(f"mesh dp={dp} x tp={tp} x sp={sp} does not cover "
                         f"the world of {n} ranks")
    shape = {"dp": dp, "tp": tp, "sp": sp}
    me = dist.get_rank()
    groups = {}
    for axis, lists in axis_groups(shape).items():
        for ranks in lists:
            # a group of the whole world is the default group
            pg = dist.new_group(ranks) if len(ranks) < n else None
            if me in ranks:
                groups[axis] = DistGroup(pg)
    return Mesh(shape=shape, groups=groups)


def in_process_mesh(sp: int) -> Mesh:
    """A mesh whose sp axis is an ``InProcessGroup`` of ``sp`` ranks on
    this process's device (for the ring); dp and tp have size 1."""
    return Mesh(shape={"dp": 1, "tp": 1, "sp": sp},
                groups={"dp": InProcessGroup(1), "tp": InProcessGroup(1),
                        "sp": InProcessGroup(sp)})


def check_heads(heads: int, tp: int) -> None:
    """The JAX package's ValueError for a head count tp does not divide."""
    if heads % tp:
        raise ValueError(
            f"head-parallel sparse attention needs heads % tp == 0, got "
            f"{heads} heads over tp={tp} (pick --tp dividing the "
            f"model's head count)")
