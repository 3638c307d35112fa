"""Hardware model the cost model plans against: the port's copy of the JAX
package's ``hw.py`` (framework-free constants, copied rather than
imported).  ``V5E`` stays the default chip of a ``Cluster`` so that plans
and estimates equal the JAX package's; the port's entry points pass
``H100``.  Only ``fingerprint`` differs: it names the CUDA device through
torch.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    """One accelerator chip."""

    name: str = "tpu-v5e"
    peak_flops_bf16: float = 197e12  # FLOP/s
    hbm_bytes: float = 16 * 1024**3  # 16 GiB
    hbm_bw: float = 819e9  # bytes/s
    ici_link_bw: float = 50e9  # bytes/s per link, per direction
    ici_links: int = 4  # 2D torus: x+/x-/y+/y-
    vmem_bytes: float = 128 * 1024**2  # ~128 MiB VMEM
    # Inter-pod (data-center network) bandwidth per chip, used for the "pod"
    # mesh axis. DCN is far slower than ICI.
    dcn_bw: float = 6.25e9  # ~50 Gbit/s per chip


@dataclasses.dataclass(frozen=True)
class ClusterSpec:
    """A rectangular slice of a v5e fleet.

    ``shape`` mirrors the jax mesh shape, e.g. (16, 16) for one pod or
    (2, 16, 16) for two pods.  The trailing two axes always live on the
    intra-pod 2D torus; a leading "pod" axis crosses DCN.
    """

    shape: tuple[int, ...] = (16, 16)
    chip: ChipSpec = dataclasses.field(default_factory=ChipSpec)

    @property
    def num_chips(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n

    @property
    def num_pods(self) -> int:
        return self.shape[0] if len(self.shape) == 3 else 1

    def axis_bandwidth(self, axis_index: int) -> float:
        """Per-chip bandwidth available to a ring collective along one mesh axis."""
        if len(self.shape) == 3 and axis_index == 0:
            return self.chip.dcn_bw
        return self.chip.ici_link_bw


V5E = ChipSpec()
POD = ClusterSpec((16, 16))
TWO_PODS = ClusterSpec((2, 16, 16))

# Nominal spec of the CPU host this container executes on — used wherever
# the estimator/profiler loop runs against the local machine (calibration
# benchmarks, examples, tests).  Deliberately rough: calibration, not the
# constants, ties estimates to the host.
HOST_CPU = ChipSpec(name="host-cpu", peak_flops_bf16=5e10, hbm_bytes=8e9,
                    hbm_bw=2e10, ici_link_bw=1e9)


def fingerprint(n_devices: "int | None" = None) -> str:
    """Stable identity of the hardware executing THIS process, used to key
    persisted profiles (core/profiler.ProfileStore): measurements taken on
    one machine must never calibrate the estimator on another.

    Format: ``"gpu-<n>x<device name>"`` (spaces as underscores, e.g.
    ``"gpu-1xNVIDIA_H100_80GB_HBM3"``) when CUDA is available, else
    ``"cpu-1xcpu"``.  ``n_devices`` overrides the visible device count —
    the elastic runtime keys profiles of a *degraded* fleet (hosts masked
    out after a failure) without spawning a resized process.
    """
    import torch
    if torch.cuda.is_available():
        kind = torch.cuda.get_device_name(0).replace(" ", "_")
        n = torch.cuda.device_count() if n_devices is None else n_devices
        return f"gpu-{n}x{kind}"
    return f"cpu-{1 if n_devices is None else n_devices}xcpu"

# The paper's evaluation hardware (H100 + NVLink + 3.2Tbps RoCE), used by the
# paper-faithful benchmark suite so Fig. 7/8/9 reproduce in the simulator with
# the same memory/bandwidth regime the authors had.
H100 = ChipSpec(
    name="h100-sxm",
    peak_flops_bf16=989e12,
    hbm_bytes=80e9,
    hbm_bw=3.35e12,
    ici_link_bw=450e9,   # NVLink within a node
    ici_links=1,
    vmem_bytes=50e6,     # SMEM+L2 stand-in (unused on GPU path)
    dcn_bw=50e9,         # 3.2 Tbps RoCE / 8 GPUs per node
)


# ---------------------------------------------------------------------------
# Ring-collective wire-cost model (bytes that cross a link, per participating
# chip).  ``nbytes`` is the FULL (unsharded) payload of the collective.
# ---------------------------------------------------------------------------

def all_reduce_bytes(nbytes: float, k: int) -> float:
    """Ring all-reduce: reduce-scatter + all-gather, 2*(k-1)/k * payload."""
    if k <= 1:
        return 0.0
    return 2.0 * (k - 1) / k * nbytes


def all_gather_bytes(nbytes: float, k: int) -> float:
    """Ring all-gather of a result of total size ``nbytes``: (k-1)/k * payload."""
    if k <= 1:
        return 0.0
    return (k - 1) / k * nbytes


def reduce_scatter_bytes(nbytes: float, k: int) -> float:
    if k <= 1:
        return 0.0
    return (k - 1) / k * nbytes


def all_to_all_bytes(nbytes: float, k: int) -> float:
    """Each chip keeps 1/k of its shard; (k-1)/k of the local bytes move."""
    if k <= 1:
        return 0.0
    return (k - 1) / k * nbytes / k


def p2p_bytes(nbytes: float) -> float:
    return float(nbytes)


def collective_seconds(wire_bytes: float, bw: float) -> float:
    return wire_bytes / bw


def dtype_bytes(dtype: str) -> int:
    return {
        "bf16": 2, "bfloat16": 2, "f16": 2, "float16": 2,
        "f32": 4, "float32": 4, "f8": 1, "int8": 1,
        "s8": 1, "u8": 1, "s32": 4, "int32": 4, "f64": 8,
        "pred": 1, "s16": 2, "u16": 2, "u32": 4, "s64": 8, "u64": 8,
    }[dtype]
