"""TPU generation presets.

Port of ``tpusim/timing/arch.py``.  The presets describe TPUs only: a
GPU ``device_kind`` maps to no preset and falls back to v5e.

The analogue of the reference's tested machine configs
(``gpu-simulator/gpgpu-sim/configs/tested-cfgs/SM7_QV100/gpgpusim.config``,
``SM7_TITANV``, ``SM75_RTX2060`` ...): one vetted parameter set per chip.

Numbers come from public sources (Google Cloud TPU docs, the "How to Scale
Your Model" scaling book's hardware tables) and are chosen so the derived
peak matches the published spec:

=====  ======  =====  ==========  ==========  =========  ==========
gen    clock   MXUs   MXU size    bf16 peak   HBM BW     ICI/link
=====  ======  =====  ==========  ==========  =========  ==========
v4     1.05    8      128x128     275 TF/s    1228 GB/s  3D, 45 GB/s
v5e    1.67    4      128x128     219 TF/s    819 GB/s   2D, 45 GB/s
v5p    1.75    8      128x128     459 TF/s    2765 GB/s  3D, 90 GB/s
v6e    1.75    4      256x256     918 TF/s    1640 GB/s  2D, 90 GB/s
=====  ======  =====  ==========  ==========  =========  ==========

(derived peak = 2 * mxus * rows * cols * clock; e.g. v5p:
2*8*128*128*1.75e9 = 458.8e12 ✓)

The v5e clock is calibrated against silicon, not the announced spec: a
compute-bound bf16 matmul chain sustains 219 TFLOP/s on a real v5e chip
(measured via the correlation harness), which is exactly 4 MXUs at
1.67 GHz — the commonly announced 197 TF/s corresponds to 1.5 GHz and
underestimates the hardware.

The tuner harness (:mod:`tpusim.harness.tuner`) refines these against a live
chip, mirroring ``util/tuner/tuner.py``.
"""

from __future__ import annotations

from tpusim_torch.timing.config import ArchConfig, IciConfig

__all__ = ["ARCH_PRESETS", "arch_preset", "detect_arch", "match_device_kind"]


def _v4() -> ArchConfig:
    return ArchConfig(
        name="v4",
        clock_ghz=1.05,
        mxu_count=8, mxu_rows=128, mxu_cols=128,
        hbm_bandwidth=1228e9, hbm_gib=32.0,
        vmem_bytes=128 * 1024 * 1024,
        ici=IciConfig(topology="torus3d", link_bandwidth=45e9),
    )


def _v5e() -> ArchConfig:
    return ArchConfig(
        name="v5e",
        clock_ghz=1.67,
        mxu_count=4, mxu_rows=128, mxu_cols=128,
        hbm_bandwidth=819e9, hbm_gib=16.0,
        vmem_bytes=128 * 1024 * 1024,
        ici=IciConfig(topology="torus2d", link_bandwidth=45e9),
    )


def _v5p() -> ArchConfig:
    return ArchConfig(
        name="v5p",
        clock_ghz=1.75,
        mxu_count=8, mxu_rows=128, mxu_cols=128,
        hbm_bandwidth=2765e9, hbm_gib=95.7,
        vmem_bytes=128 * 1024 * 1024,
        ici=IciConfig(topology="torus3d", link_bandwidth=90e9),
    )


def _v6e() -> ArchConfig:
    return ArchConfig(
        name="v6e",
        clock_ghz=1.75,
        mxu_count=4, mxu_rows=256, mxu_cols=256,
        hbm_bandwidth=1640e9, hbm_gib=32.0,
        vmem_bytes=128 * 1024 * 1024,
        ici=IciConfig(topology="torus2d", link_bandwidth=90e9),
    )


ARCH_PRESETS: dict[str, "ArchConfig"] = {
    "v4": _v4(),
    "v5e": _v5e(),
    "v5p": _v5p(),
    "v6e": _v6e(),
}

#: map from jax ``device_kind`` strings to preset names.
_DEVICE_KIND_MAP = {
    "tpu v4": "v4",
    "tpu v5 lite": "v5e",
    "tpu v5e": "v5e",
    "tpu v5": "v5p",
    "tpu v5p": "v5p",
    "tpu v6 lite": "v6e",
    "tpu v6e": "v6e",
}


def arch_preset(name: str) -> ArchConfig:
    key = name.lower()
    if key not in ARCH_PRESETS:
        raise KeyError(
            f"unknown arch preset {name!r}; available: {sorted(ARCH_PRESETS)}"
        )
    return ARCH_PRESETS[key]


def match_device_kind(device_kind: str) -> str | None:
    """Preset name a ``device_kind`` CONFIDENTLY maps to, or None when
    it is unrecognized — callers that must not guess (the static
    analyzer\'s trace/config agreement check) key on the None."""
    kind = device_kind.lower().strip()
    if kind in _DEVICE_KIND_MAP:
        return _DEVICE_KIND_MAP[kind]
    for pat, preset in sorted(
        _DEVICE_KIND_MAP.items(), key=lambda kv: -len(kv[0])
    ):
        if kind.startswith(pat):
            return preset
    return None


def detect_arch(device_kind: str) -> ArchConfig:
    """Best-effort map of a jax ``device.device_kind`` to a preset
    (``'TPU v5 lite'`` → v5e).  Falls back to v5e."""
    return arch_preset(match_device_kind(device_kind) or "v5e")
