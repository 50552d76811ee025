"""Per-device peak rates and the SpMV speed-of-light estimator.

The reference reports GFLOP/s = 2*nnz*iters/t (``bench_spmv_mmf.cpp:168``)
with no roofline context. Here the nnz/s ceiling comes from the
device's memory bandwidth and the bytes a kernel must move per
nonzero. Peaks are keyed by ``jax.Device.device_kind``; a device not in
the table is an error, never a default.
"""

from __future__ import annotations

import dataclasses

__all__ = [
    "DeviceSpec",
    "PEAKS",
    "device_spec",
    "detect_device",
    "spmv_bytes_per_nnz",
    "speed_of_light_nnz_s",
]


@dataclasses.dataclass(frozen=True)
class DeviceSpec:
    name: str
    hbm_bw_bytes_s: float  # peak device-memory bandwidth
    hbm_bytes: int
    l2_bytes: int
    bf16_flops: float  # dense tensor-core rate
    f32_flops: float  # float32 outside the tensor cores
    source: str


#: NVIDIA H100 SXM data sheet (dense rates, no sparsity; at the full
#: 700 W power limit — a card set below it cannot hold its top clock)
_H100_SXM = DeviceSpec(
    "H100 SXM", 3.35e12, 80 * 10**9, 50 * 2**20, 989e12, 67e12,
    "NVIDIA H100 Tensor Core GPU data sheet (SXM5)",
)

PEAKS = {
    "NVIDIA H100 80GB HBM3": _H100_SXM,
}


def device_spec(device_kind: str) -> DeviceSpec:
    """Peak rates of a device by ``device_kind``; raises for an unknown
    device."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise ValueError(
            f"no peak rates for device kind {device_kind!r}; add it to "
            "cfs_spmv.utils.roofline.PEAKS with its source"
        ) from None


def detect_device() -> DeviceSpec:
    """Peak rates of ``jax.devices()[0]``."""
    import jax

    return device_spec(jax.devices()[0].device_kind)


def spmv_bytes_per_nnz(
    *,
    value_bytes: int = 4,
    index_bytes: int = 4,
    nnz: int,
    nrows: int,
    ncols: int,
    vector_bytes: int = 4,
) -> float:
    """Average memory bytes per logical nonzero of the reference-
    equivalent CSR stream: value + column index per nonzero, one read of
    x and one write of y."""
    stream = (value_bytes + index_bytes) * nnz
    vecs = vector_bytes * (ncols + nrows)
    return (stream + vecs) / max(nnz, 1)


def speed_of_light_nnz_s(spec: DeviceSpec, bytes_per_nnz: float) -> float:
    """Memory-roofline nonzeros/second ceiling."""
    return spec.hbm_bw_bytes_s / max(bytes_per_nnz, 1e-12)
