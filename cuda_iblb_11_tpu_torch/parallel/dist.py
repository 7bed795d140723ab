"""The process group of a ``--distributed`` run and the transport its mesh
moves data over: the port of ``jax.distributed.initialize()`` (JAX
cli.py:154-161), after which one mesh spans every rank's shards.

``init_from_env`` reads the environment that ``torchrun`` (``python -m
torch.distributed.run``) sets: RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR,
MASTER_PORT.  A rank on the card first takes card LOCAL_RANK mod the
visible cards (``torch.cuda.set_device``), then joins a gloo group, and
every rank gathers the world's device map (host name, card index).  The
transport is chosen once from that map, by rule:

  * ``nccl``: every rank has a card of its own (no two ranks on one card
    of one host); the halos move card to card;
  * ``gloo`` with the halos staged through pinned host memory: ranks share
    a card (NCCL refuses two ranks on one card) — gloo has no send/recv of
    CUDA tensors, so each one is copied to the host and back;
  * ``gloo``: the ranks run on the CPU.

The primitives:

  * ``move``: one batched point-to-point exchange (``batch_isend_irecv``).
    Every rank lists the same items in the same global order and posts its
    part of them, so the sends and receives of each pair of ranks match in
    order and nothing waits on a message posted later.  A receiver learns
    an item's shape and dtype from a small header the first time a call
    site (its tag) moves it, and keeps it in the caller's cache (one per
    sim, made in the same order on every rank): later calls of the site
    send the payload alone (the sender raises if the shape moved).  Every item
    travels as its raw bytes, so no value is converted on the way.
  * ``all_sum_ordered``: every partial sent to every rank (an all-gather),
    then summed in list order on each rank, in the partials' dtype: the
    order and dtype of the single-process mesh's fixed-order sum
    (``sharded._psum``), so every rank has its bits.  JAX's fixed-order
    ``psum`` becomes this; NCCL's all_reduce fixes no order and is not
    used.
  * ``gather``: the items to rank 0 (snapshots, npz checkpoints);
  * ``barrier``.

``current()`` is the transport of this process, or None when no group was
set up (the one-process mesh, which moves nothing through this module).
"""

from __future__ import annotations

import datetime
import os
import socket

import torch
import torch.distributed as tdist

_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")
_HEAD = 10          # header slots: dtype code, ndim, up to 8 dims
_TIMEOUT = datetime.timedelta(seconds=600)   # a lost peer ends the run
_DTYPES = (torch.float32, torch.float64, torch.bfloat16, torch.float16,
           torch.int64, torch.int32, torch.int16, torch.uint8, torch.bool)

_CURRENT = None


def current():
    """The Transport of this process, or None without a process group."""
    return _CURRENT


def choose_transport(device_map):
    """(backend, staged) for the world's device map, one (host name, card
    index, or None on the CPU) per rank, the same on every rank: plain
    gloo on the CPU, nccl where every rank has a card of its own, gloo
    staged through host memory where ranks share a card.  Ranks that mix
    the CPU and the card are refused (on every rank alike)."""
    cards = [card for _, card in device_map]
    if all(card is None for card in cards):
        return "gloo", False
    if any(card is None for card in cards):
        raise ValueError(f"the ranks mix the CPU and the card: {device_map}")
    if len(set(device_map)) == len(device_map):
        # more than one rank on NCCL is unexercised until a multi-card host
        return "nccl", False
    return "gloo", True


def _encode(dtype, shape) -> torch.Tensor:
    if len(shape) > _HEAD - 2:
        raise ValueError(f"cannot move a tensor of {len(shape)} dims")
    head = [_DTYPES.index(dtype), len(shape), *shape]
    return torch.tensor(head + [0] * (_HEAD - len(head)), dtype=torch.int64)


def _decode(head: torch.Tensor):
    h = [int(v) for v in head.cpu()]
    return _DTYPES[h[0]], tuple(h[2:2 + h[1]])


def _bytes(t: torch.Tensor) -> torch.Tensor:
    """A contiguous tensor's storage as a flat uint8 view."""
    return t.reshape(-1).view(torch.uint8)


class Transport:
    """One rank's view of the process group: its rank, the world size, its
    device, and the transport chosen for the world (module docstring)."""

    def __init__(self, rank: int, world: int, device: torch.device,
                 backend: str, staged: bool, group=None):
        self.rank, self.world, self.device = rank, world, device
        self.backend, self.staged, self.group = backend, staged, group

    def describe(self) -> dict:
        return {"world": self.world, "rank": self.rank,
                "transport": self.name}

    @property
    def name(self) -> str:
        if self.backend == "nccl":
            return "nccl"
        return "gloo (staged through host memory)" if self.staged else "gloo"

    # --- the wire

    def _wire(self, t: torch.Tensor) -> torch.Tensor:
        """A buffer like t where the transport carries it: t itself, or for
        gloo an (uninitialised, pinned) host buffer for a card tensor, or
        for nccl a card buffer for a host tensor."""
        if self.backend == "nccl":
            if t.device == self.device:
                return t
            return torch.empty(t.shape, dtype=t.dtype, device=self.device)
        if t.device.type == "cpu":
            return t
        return torch.empty(t.shape, dtype=t.dtype, pin_memory=True)

    def _p2p(self, sends, recvs):
        """Post the sends [(peer, tensor)] and receives [(peer, tensor to
        fill)] in one batch and wait for all of them."""
        if not sends and not recvs:
            return
        ops, back = [], []
        for peer, t in sends:
            w = self._wire(t)
            if w is not t:
                w.copy_(t)     # a blocking copy: the bytes are there to send
            ops.append(tdist.P2POp(tdist.isend, _bytes(w), peer,
                                   group=self.group))
        for peer, t in recvs:
            w = self._wire(t)
            ops.append(tdist.P2POp(tdist.irecv, _bytes(w), peer,
                                   group=self.group))
            if w is not t:
                back.append((t, w))
        for req in tdist.batch_isend_irecv(ops):
            req.wait()
        for t, w in back:
            t.copy_(w)

    # --- the primitives

    def move(self, tag: str, items, cache: dict):
        """items: (value, src rank, dst rank, dst device) in one global
        order, the same list on every rank; value is this rank's tensor
        where it is the source, else ignored.  Returns the items' values on
        their destination rank (None elsewhere): a local item is
        ``value.to(device)``, a remote one arrives by send/recv.  cache:
        the caller's {(tag, item, src, dst): (dtype, shape)}, the same
        dict on every call of the caller's sites."""
        out = [None] * len(items)
        head_s, head_r, sends, recvs = [], [], [], []
        for i, (v, src, dst, dev) in enumerate(items):
            me_src, me_dst = src == self.rank, dst == self.rank
            if me_src and me_dst:
                out[i] = v.to(dev)
                continue
            if not (me_src or me_dst):
                continue
            key = (tag, i, src, dst)
            known = cache.get(key)
            if me_src:
                v = v.contiguous()
                meta = (v.dtype, tuple(v.shape))
                if known is None:
                    cache[key] = meta
                    head_s.append((dst, _encode(*meta)))
                elif known != meta:
                    raise RuntimeError(
                        f"move {tag!r} item {i}: {meta} where this call "
                        f"site moved {known} before")
                sends.append((dst, v))
            else:
                if known is None:
                    head_r.append((src, torch.zeros(_HEAD, dtype=torch.int64),
                                   key))
                recvs.append((src, i, dev, key))
        if head_s or head_r:
            self._p2p(head_s, [(p, h) for p, h, _ in head_r])
            for _, h, key in head_r:
                cache[key] = _decode(h)
        bufs = []
        for src, i, dev, key in recvs:
            dtype, shape = cache[key]
            out[i] = torch.empty(shape, dtype=dtype, device=dev)
            bufs.append((src, out[i]))
        self._p2p(sends, bufs)
        return out

    def all_sum_ordered(self, tag: str, parts, cache: dict):
        """parts: (value, src rank) in one global order; the sum of every
        value in that order, on every rank's device, in the values' dtype:
        ``total = v0; total = total + v1; ...`` as sharded._psum adds."""
        items = [(v, src, r, self.device) for v, src in parts
                 for r in range(self.world)]
        got = self.move(tag, items, cache)
        vals = got[self.rank::self.world]
        total = vals[0]
        for v in vals[1:]:
            total = total + v
        return total

    def gather(self, tag: str, parts, device, cache: dict):
        """parts: (value, src rank); every value on rank 0's `device` (a
        list there, None on the other ranks)."""
        got = self.move(tag, [(v, src, 0, device) for v, src in parts],
                        cache)
        return got if self.rank == 0 else None

    def barrier(self):
        tdist.barrier()


def init_from_env(device="cuda") -> Transport:
    """Join the process group that torchrun's environment describes and
    choose its transport (module docstring).  A rank on the card takes its
    card before anything else touches it.  Raises where the environment is
    incomplete or the card is missing; the group's collectives time out
    after _TIMEOUT, so a lost peer ends the run."""
    global _CURRENT
    if _CURRENT is not None:
        return _CURRENT
    missing = [k for k in _ENV if k not in os.environ]
    if missing:
        raise RuntimeError(
            f"--distributed needs the environment torchrun sets "
            f"({', '.join(_ENV)}); missing {', '.join(missing)}")
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    local = int(os.environ["LOCAL_RANK"])
    dev = torch.device(device)
    card = None
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("--distributed on cuda, but "
                               "torch.cuda.is_available() is False")
        card = local % torch.cuda.device_count()
        torch.cuda.set_device(card)
        dev = torch.device("cuda", card)
    # env://: under torchrun the ranks join the launcher's store
    tdist.init_process_group("gloo", init_method="env://", rank=rank,
                             world_size=world, timeout=_TIMEOUT)
    device_map = [None] * world
    tdist.all_gather_object(device_map, (socket.gethostname(), card))
    backend, staged = choose_transport([tuple(d) for d in device_map])
    group = None
    if backend == "nccl":
        group = tdist.new_group(backend="nccl", timeout=_TIMEOUT)
        # NCCL sets its communicator up at its first operation, so a
        # refusal (two ranks on one card, say) surfaces here, not in the run
        tdist.barrier(group=group, device_ids=[card])
    _CURRENT = Transport(rank, world, dev, backend, staged, group)
    return _CURRENT


def shutdown():
    """Leave the process group (after a barrier, so no rank tears it down
    under a peer still in a collective)."""
    global _CURRENT
    if _CURRENT is None:
        return
    try:
        tdist.barrier()
    finally:
        tdist.destroy_process_group()
        _CURRENT = None
