"""Published peaks of the cards the benchmark runs on (dense rates, no
sparsity), by ``torch.cuda.get_device_name()``. NVIDIA's H100 SXM data
sheet: 989 TFLOP/s bf16, 67 TFLOP/s float32 outside the tensor cores,
3.35 TB/s of HBM3, at the full 700 W."""
from __future__ import annotations

H100_SXM = {"bf16_flops": 989e12, "fp32_flops": 67e12, "hbm_bytes": 3.35e12}

PEAKS = {"NVIDIA H100 80GB HBM3": H100_SXM}


def peaks(device_name: str):
    """The card's peaks; a card the table does not hold raises (a share
    of an unknown peak would mean nothing)."""
    if device_name not in PEAKS:
        raise KeyError(f"no published peaks for {device_name!r}")
    return PEAKS[device_name]


def least_time(flops: float, nbytes: float, peak) -> float:
    """The least seconds a launch needs: its operations at the bf16 peak
    or its bytes at the HBM peak, whichever is longer."""
    return max(flops / peak["bf16_flops"], nbytes / peak["hbm_bytes"])
