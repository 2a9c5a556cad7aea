"""Device meshes for the batch verify: the port of
fabric_mod_tpu/parallel/mesh.py.

The reference shards the verify program's batch axis over a 1-D `dp`
mesh of chips with NamedShardings and lets GSPMD partition it.  The
port has no partitioner: a mesh here is a plain tuple of torch devices
in dp order, and `bccsp.gpu.GpuVerifier(mesh=...)` splits each bucket
into one contiguous lane range per device (`lane_ranges`), packs,
uploads and verifies each range on its own device with the same
hand-written kernels, and gathers the verdicts onto the first device.
Verification is embarrassingly parallel across lanes, so nothing
crosses devices but the verdicts.

`slice_meshes` carves the devices into disjoint equal slices, one per
channel shard (sharding/): N channels' verify calls then run on
disjoint cards instead of one channel's calls owning every card.

Device counts come from `torch.cuda.device_count()`.  The CPU stands in
for any number of a mesh's devices (the tests pass ("cpu", "cpu")): it
is the one device type allowed to repeat.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from fabric_mod_tpu_torch import device as _device

Mesh = Tuple[torch.device, ...]


def _mesh(devs: Sequence[torch.device]) -> Mesh:
    devs = tuple(devs)
    if not devs:
        raise ValueError("empty device subset")
    repeated = [d for d in devs if d.type != "cpu"]
    if len(set(repeated)) != len(repeated):
        raise ValueError(f"duplicate devices in subset: {list(devs)}")
    if len({d.type for d in devs}) != 1:
        raise ValueError(f"a mesh holds one device type: {list(devs)}")
    return devs


def _cuda_devices() -> List[torch.device]:
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def data_mesh(n_devices: Optional[int] = None, devices=None) -> Mesh:
    """The first `n_devices` CUDA devices (default: all), or an explicit
    `devices` subset (dp order as given).  The two selectors are
    mutually exclusive; an empty subset, a repeated CUDA device, mixed
    device types, or a device that does not exist raises."""
    if devices is not None:
        if n_devices is not None:
            raise ValueError("pass n_devices OR devices, not both")
        devs = _mesh([torch.device(d) for d in devices])
        if devs[0].type == "cuda":
            _device.resolve(devs[0])          # raises without CUDA
            count = torch.cuda.device_count()
            devs = _mesh([torch.device("cuda", torch.cuda.current_device()
                                       if d.index is None else d.index)
                          for d in devs])
            for d in devs:
                if d.index >= count:
                    raise ValueError(f"no device {d}: have {count}")
        return devs
    devs = _cuda_devices()
    n = n_devices or len(devs)
    if n > len(devs):
        raise ValueError(f"asked for {n} devices, have {len(devs)}")
    return _mesh(devs[:n])


def slice_meshes(n_slices: int, n_devices: Optional[int] = None
                 ) -> List[Mesh]:
    """The first `n_devices` CUDA devices (default: all) as `n_slices`
    disjoint, contiguous, equal meshes — one per channel shard.  The
    count must split evenly: a ragged split would give slices different
    bucket divisibility (bccsp/gpu.py `_bucket`)."""
    if n_slices <= 0:
        raise ValueError("n_slices must be positive")
    devs = _cuda_devices()
    n = n_devices or len(devs)
    if n > len(devs):
        raise ValueError(f"asked for {n} devices, have {len(devs)}")
    if n % n_slices != 0:
        raise ValueError(
            f"{n} devices do not split into {n_slices} equal slices")
    per = n // n_slices
    return [_mesh(devs[i * per:(i + 1) * per]) for i in range(n_slices)]


def lane_ranges(size: int, n_devices: int) -> List[Tuple[int, int]]:
    """Each mesh device's contiguous [lo, hi) lane range of a `size`-lane
    bucket, in dp order (the reference's `verify_shardings` and
    `fused_verify_shardings` in one: the byte planes and the message
    words have the batch as their leading axis on the host, so a range
    slices both; each range is then packed into that device's (rows,
    lanes) planes, the batch their trailing axis).  `n_devices` must
    divide `size`."""
    if n_devices <= 0 or size % n_devices != 0:
        raise ValueError(f"{n_devices} devices do not split {size} lanes "
                         "evenly")
    per = size // n_devices
    return [(i * per, (i + 1) * per) for i in range(n_devices)]
