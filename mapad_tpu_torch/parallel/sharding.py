"""Data parallelism of the pool search over several devices.

Counterpart of mapad_tpu/parallel/sharding.py.  The domain's parallelism is
data parallelism over reads: each shard searches its own contiguous slice
of a block's reads while the FMD-index replicates.  A "mesh" here is a list
of `torch.device`s, one per shard in shard order; it may name one device
several times (two shards on one card run on two streams), which is also
how the CPU tests stand in for JAX's virtual CPU devices (`[cpu] * D`).
"""

from __future__ import annotations

import torch

from ..ops.fm import DeviceFmIndex


def make_mesh(n_devices: int | None = None) -> list:
    """Every visible card (`cuda:0` ... `cuda:{n-1}`), or the first
    `n_devices` of them."""
    n = torch.cuda.device_count()
    if n_devices is not None:
        if n < n_devices:
            raise RuntimeError(
                f"requested a {n_devices}-device mesh but only {n} devices "
                f"are visible"
            )
        n = n_devices
    return [torch.device("cuda", i) for i in range(n)]


def automatic_mesh(device) -> list | None:
    """The mesh an engine on `device` takes by itself: every visible card
    where the device names none in particular (`cuda` alone, the default)
    and more than one is visible; else None.  A named card (`cuda:i`) is
    that card alone: the layout of a process or a worker per card."""
    device = torch.device(device)
    if (device.type == "cuda" and device.index is None
            and torch.cuda.device_count() > 1):
        return make_mesh()
    return None


def canonical(dev) -> torch.device:
    """`dev` with its index resolved (`cuda` alone is the current card), so
    that devices compare equal when they name the same card."""
    dev = torch.device(dev)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def replicate(mesh, index: DeviceFmIndex) -> list:
    """The index on every shard's device, one copy per distinct device:
    shards on the same device share it.  -> one DeviceFmIndex per shard."""
    copies = {}
    out = []
    for dev in mesh:
        dev = canonical(dev)
        if dev not in copies:
            copies[dev] = (
                index if canonical(index.rows.device) == dev
                else index._replace(rows=index.rows.to(dev),
                                    less=index.less.to(dev),
                                    sentinels=index.sentinels.to(dev))
            )
        out.append(copies[dev])
    return out


def shard_search_inputs(mesh, prep: dict) -> list:
    """Per-read (or per-lane) arrays cut into len(mesh) contiguous parts
    along their leading axis, each on its shard's device -> one dict per
    shard.  The leading axis must divide; host-only entries (keys starting
    with `_`) pass through to every shard as they are."""
    D = len(mesh)
    out = [{} for _ in range(D)]
    for k, v in prep.items():
        if k.startswith("_"):
            for part in out:
                part[k] = v
            continue
        assert v.shape[0] % D == 0, f"{k}: {v.shape[0]} rows over {D} shards"
        for part, piece, dev in zip(out, torch.chunk(v, D), mesh):
            part[k] = piece.to(dev)
    return out
