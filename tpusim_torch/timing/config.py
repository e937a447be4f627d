"""Typed configuration system.

Port of ``tpusim/timing/config.py``.  It reads the same repo-root
``configs/`` overlays (and ``$TPUSIM_TUNED_DIR``) as the JAX package.

The rebuild of the reference's option registry (``src/option_parser.{h,cc}``,
used ~300× via ``option_parser_register``) and its config-composition scheme
(base ``gpgpusim.config`` + per-benchmark overlays + ``extra_params``
concatenation, ``util/job_launching/run_simulations.py:303-328``).

Design changes, per SURVEY.md §7: configs are **typed dataclasses** instead of
a stringly-typed flag soup, but the composability is preserved — a named arch
preset, overlaid with dicts, JSON files, or reference-style ``-flag value``
flag files (so run dirs can still concatenate overlays the way
``append_gpgpusim_config`` does).
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field, fields
from pathlib import Path
from typing import Any

__all__ = [
    "ArchConfig",
    "CONFIG_FIELD_RULES",
    "IciConfig",
    "SimConfig",
    "load_config",
    "parse_flag_file",
    "overlay",
    "tuned_overlay_path",
]


@dataclass(frozen=True)
class IciConfig:
    """Inter-chip interconnect parameters (the ``icnt`` config equivalent —
    reference: ``-network_mode`` + intersim config, ``icnt_wrapper.h:36-64``).
    """

    topology: str = "torus3d"          # torus3d | torus2d | mesh2d | ring
    # per-link, per-direction bandwidth in bytes/second
    link_bandwidth: float = 90e9
    # serialization latency per hop (seconds): SerDes + router
    hop_latency: float = 1e-6
    # software/launch latency per collective (seconds)
    launch_latency: float = 2e-6
    # links per chip per torus axis direction (1 = single link each way)
    links_per_axis: int = 1
    # fraction of peak link bandwidth achievable (protocol efficiency)
    efficiency: float = 0.85
    # DCN (multi-slice) parameters, used when a group spans slices
    dcn_bandwidth: float = 25e9
    dcn_latency: float = 10e-6
    chips_per_slice: int = 0            # 0 = single slice
    # modeled DCN fabric (tpusim.dcn): per-slice NIC count gates the
    # whole fabric — 0 leaves the flat dcn_bandwidth/dcn_latency scalar
    # model in charge (byte-identical to the pre-fabric pricing)
    dcn_nics_per_slice: int = 0
    # per-NIC-hop bandwidth (bytes/s) and latency (s); 0 falls back to
    # dcn_bandwidth / dcn_latency so a fabric can be enabled by NIC
    # count alone
    dcn_hop_bandwidth: float = 0.0
    dcn_hop_latency: float = 0.0
    # spine oversubscription factor (>= 1 divides usable bandwidth)
    dcn_oversubscription: float = 1.0
    # network implementation (the -network_mode equivalent):
    # "analytic" = closed-form schedule math (collectives.py);
    # "detailed" = per-packet link contention sim (detailed.py / ici_net.cpp)
    network_mode: str = "analytic"
    # packet size the detailed network splits transfers into
    packet_bytes: float = 16384.0


@dataclass(frozen=True)
class ArchConfig:
    """One TPU generation's TensorCore + memory + ICI parameters.

    The analogue of a ``gpgpusim.config`` machine section
    (``configs/tested-cfgs/SM7_QV100/gpgpusim.config:64-166``: SM count,
    clocks, mem controllers) plus the ``trace.config`` latency tables.
    """

    name: str = "v5p"
    # --- clocks -----------------------------------------------------------
    clock_ghz: float = 1.75

    # --- MXU (systolic array) --------------------------------------------
    mxu_count: int = 8
    mxu_rows: int = 128
    mxu_cols: int = 128
    # pipeline fill/drain latency (cycles), paid once per matmul op
    mxu_fill_cycles: int = 128
    # minimum cycles per systolic pass: the next pass's weight tile loads
    # while the current one streams (double-buffered), so a pass can't
    # retire faster than the weight load — the floor small-m matmuls hit
    # (fit against the lstm_layer silicon fixture, round 4)
    mxu_weight_stall_cycles: int = 64
    # sustained fraction of the systolic-pass rate on large matmuls
    # (pipeline bubbles, operand skew): v5e silicon sustains 190.4 TF/s
    # of a 219 TF/s modeled peak on a 4096^3 bf16 matmul (0.87)
    mxu_efficiency: float = 1.0
    # dtype multiplier: relative MAC throughput vs bf16
    dtype_mult: dict[str, float] = field(
        default_factory=lambda: {
            "bf16": 1.0, "f16": 1.0,
            "f32": 0.25,           # fp32 via multi-pass on the MXU
            "f64": 0.05,
            "s8": 2.0, "u8": 2.0, "s4": 4.0, "u4": 4.0,
            "f8e4m3": 2.0, "f8e5m2": 2.0, "f8e4m3fn": 2.0,
            "s32": 0.25, "u32": 0.25,
        }
    )

    # --- VPU --------------------------------------------------------------
    vpu_sublanes: int = 8
    vpu_lanes: int = 128
    vpu_alus: int = 4                  # parallel ALU ops per lane per cycle
    # transcendental ops (exp/log/tanh/...) per cycle across the VPU
    # (a rate, not a count — the tuner/refiner fit fractional values)
    vpu_transcendental_per_cycle: float = 512.0
    # reductions accumulate below elementwise rate; the per-element cost
    # scales with dtype width (the VPU accumulates packed words), so this
    # is normalized to f32: a v5e f32 2D-sum measured 9.2x elementwise
    # rate, and the same formula lands the bf16 row-sum at 4.6x
    vpu_reduce_slowdown: float = 9.2
    # extra cycles per OUTPUT element when the reduced dims include the
    # minor (lane) dimension — the lane-shuffle tail of a [.,128]->[.]
    # GEMV-style reduce (decode_step fixture)
    vpu_lane_cross_cycles: float = 0.7
    # spatial convolutions pay an im2col/emitter overhead the pure
    # systolic-pass model can't see (conv2d fixture: 3x3 conv sustains
    # 0.83 of the modeled pass-streaming rate)
    mxu_conv_tap_efficiency: float = 0.83

    # --- scalar / control -------------------------------------------------
    scalar_op_cycles: int = 1
    # fixed per-HLO-op dispatch overhead in cycles (sequencer + DMA setup)
    op_overhead_cycles: int = 35

    # --- memory -----------------------------------------------------------
    # per-noncontiguous-row cost of a scattered gather/scatter (DMA
    # descriptor issue + row-granular HBM access); the embedding fixture
    # read -50% without it (VERDICT r3 #7).  Charged per gathered row, so
    # a random 2KB-row embedding lookup runs well below stream bandwidth
    gather_row_overhead_cycles: int = 16
    # async DMA start latency (descriptor setup + first-byte), seconds.
    # Overlaps across transfers (TPUs have many DMA engines) but delays
    # each transfer's completion: an 8KB per-iteration copy-start measured
    # 1.57us on v5e silicon (lstm fixture) — pure latency, not bandwidth
    dma_issue_latency: float = 1.4e-6
    # a layout-changing copy is a physical relayout (tile shuffle through
    # the vector unit), streaming well below the plain-copy rate: the
    # conv2d fixture's HBM->vmem transposing copy ran at 0.42x the
    # same-layout stream bandwidth
    relayout_efficiency: float = 0.45
    # relayouts that keep the minor (lane) dimension dense in 128-lane
    # tiles move contiguous 256B+ runs — tile reordering, not element
    # shuffling — at near-stream rate (decode fixture: a 33.5MB
    # {4,3,2,1,0}->{4,1,3,2,0} HBM->vmem copy, minor dim 128 on both
    # sides, achieved 452GB/s = 0.66x pin while conv2d's 64-lane
    # transposing copy ran at 0.40x)
    relayout_lane_efficiency: float = 0.66
    # minimum device cycles for a standalone sub-tile kernel: a bare
    # slice/DUS of less than a tile, or a scalar-output reduce, still
    # pays sequencer dispatch + sublane addressing + scalar writeback
    # (v5e silicon: [1,1] slices 229-567ns, a scalar reduce-fusion
    # 329ns, a one-row DUS 594ns — while the model's roofline floor is
    # ~5ns; XLA's own cost model floors the same kernels at ~1830
    # estimated_cycles)
    small_kernel_floor_cycles: int = 700
    # vmem->vmem copies stream through load/store ports, not at the full
    # banked vmem bandwidth the roofline uses for fused operand reads
    # (conv2d %copy.11: 6.4MB same-layout vmem copy at 2.4TB/s vs the
    # 8.2TB/s operand-streaming rate)
    vmem_copy_efficiency: float = 0.3
    # pure data-movement fusions (dynamic-slice/DUS chains, e.g. KV-cache
    # reads) run at DMA slice rate rather than operand-streaming rate
    # (decode fixture: 16.8MB vmem slice at 4.1TB/s aggregate)
    vmem_slice_efficiency: float = 0.5
    hbm_bandwidth: float = 2765e9      # bytes/sec, pin peak
    # achieved fraction of peak for streaming access (refresh, bank
    # conflicts, DMA gaps); calibrated on v5e silicon via bench.py
    hbm_efficiency: float = 0.72
    hbm_latency: float = 700e-9        # seconds, first-byte
    hbm_gib: float = 95.7
    vmem_bytes: int = 128 * 1024 * 1024
    vmem_bandwidth_mult: float = 10.0  # vmem bw as multiple of HBM bw
    # host <-> HBM (PCIe/DMA) for infeed/outfeed & memcpy modeling
    host_bandwidth: float = 32e9
    host_latency: float = 5e-6

    # --- ICI --------------------------------------------------------------
    ici: IciConfig = field(default_factory=IciConfig)

    # --- derived ----------------------------------------------------------
    @property
    def clock_hz(self) -> float:
        return self.clock_ghz * 1e9

    @property
    def mxu_flops_per_cycle(self) -> float:
        """Peak bf16 FLOPs per cycle across all MXUs (2 flops per MAC)."""
        return 2.0 * self.mxu_count * self.mxu_rows * self.mxu_cols

    @property
    def peak_bf16_flops(self) -> float:
        return self.mxu_flops_per_cycle * self.clock_hz

    @property
    def vpu_flops_per_cycle(self) -> float:
        return float(self.vpu_sublanes * self.vpu_lanes * self.vpu_alus)

    @property
    def hbm_bytes_per_cycle(self) -> float:
        return self.hbm_bandwidth * self.hbm_efficiency / self.clock_hz

    @property
    def vmem_bytes_per_cycle(self) -> float:
        return self.vmem_bandwidth_mult * self.hbm_bandwidth / self.clock_hz

    def seconds_to_cycles(self, s: float) -> float:
        return s * self.clock_hz

    def cycles_to_seconds(self, c: float) -> float:
        return c / self.clock_hz

    def mxu_dtype_mult(self, dtype: str) -> float:
        return self.dtype_mult.get(dtype, 0.25)


@dataclass(frozen=True)
class SimConfig:
    """Simulation-run knobs (the driver/behavioral flags of ``gpu-sim.h``:
    stream windowing ``main.cc:74-115``, deadlock detect, stat sampling)."""

    arch: ArchConfig = field(default_factory=ArchConfig)
    # max kernels in flight across streams (reference: window of concurrent
    # kernels, main.cc:74)
    kernel_window: int = 8
    # model memcpy time (reference: -gpgpu_perf_sim_memcpy)
    perf_sim_memcpy: bool = True
    # model compute/collective overlap (False = serial like the fork's
    # -nccl_allreduce_latency add at main.cc:121)
    overlap_collectives: bool = True
    # sample interval stats every N cycles (reference: gpu_stat_sample_freq)
    stat_sample_cycles: int = 100_000
    # deadlock detection (reference: -gpu_deadlock_detect)
    deadlock_detect: bool = True
    deadlock_cycles: int = 1_000_000_000
    # default trip count for while loops whose bound isn't in the HLO
    default_loop_trip_count: int = 1
    # power model on/off (reference: -power_simulation_enabled)
    power_enabled: bool = False
    # DVFS operating point (reference: AccelWattch DVFS support): voltage/
    # frequency scale applied to the power coefficients; pair with a
    # clock_ghz overlay — power.model.dvfs_overlays builds both
    dvfs_scale: float = 1.0
    # checkpoint/resume at kernel granularity (reference:
    # -checkpoint_kernel / -resume_kernel, abstract_hardware_model.cc:136):
    # resume fast-forwards the first N kernel launches; checkpoint stops
    # the replay after N launches and records the stop point
    resume_kernel: int = 0
    checkpoint_kernel: int = 0
    # sub-kernel checkpoint/resume at ENTRY-OP granularity inside one
    # module replay (reference: per-instruction functional checkpoint,
    # abstract_hardware_model.h:1280-1288).  checkpoint_op=K stops the
    # entry walk after K scheduled ops and drains in-flight transfers (a
    # state snapshot cannot leave DMA mid-flight); resume_op=K
    # fast-forwards the first K ops, treating transfers they started as
    # already complete.  The boundary is therefore a barrier: for a
    # schedule with nothing in flight at op K the two halves partition the
    # full run exactly.
    resume_op: int = 0
    checkpoint_op: int = 0
    # model HBM bandwidth sharing between async DMA and compute (the
    # FR-FCFS/queueing slot of the reference, dram_sched.h:41 — here a
    # fair-share split when both stream concurrently)
    model_hbm_contention: bool = True
    # enforce the vmem capacity budget: when a module pins more S(1) bytes
    # than arch.vmem_bytes, the overflow fraction of vmem traffic is
    # re-priced at HBM bandwidth (spill) — the shmem/L1 capacity analogue
    # (gpu-cache.h adaptive_cache_config)
    model_vmem_capacity: bool = True


# ---------------------------------------------------------------------------
# Field validation metadata (consumed by tpusim_torch.analysis.config_passes)
# ---------------------------------------------------------------------------

#: per-config-path validation classes, declared next to the dataclasses
#: they describe so a new knob gets its rule in the same diff.  Keys are
#: dotted paths relative to a SimConfig; classes:
#:   positive  — must be > 0 and finite (clocks, bandwidths, dimensions)
#:   nonneg    — must be >= 0 and finite (latencies, cycle counts)
#:   fraction  — must be in (0, 1] (efficiencies, achieved-rate scales)
#:   enum:<..> — must be one of the listed values
CONFIG_FIELD_RULES: dict[str, str] = {
    # --- ArchConfig -------------------------------------------------------
    "arch.clock_ghz": "positive",
    "arch.mxu_count": "positive",
    "arch.mxu_rows": "positive",
    "arch.mxu_cols": "positive",
    "arch.mxu_fill_cycles": "nonneg",
    "arch.mxu_weight_stall_cycles": "nonneg",
    "arch.mxu_efficiency": "fraction",
    "arch.mxu_conv_tap_efficiency": "fraction",
    "arch.vpu_sublanes": "positive",
    "arch.vpu_lanes": "positive",
    "arch.vpu_alus": "positive",
    "arch.vpu_transcendental_per_cycle": "positive",
    "arch.vpu_reduce_slowdown": "positive",
    "arch.vpu_lane_cross_cycles": "nonneg",
    "arch.scalar_op_cycles": "nonneg",
    "arch.op_overhead_cycles": "nonneg",
    "arch.gather_row_overhead_cycles": "nonneg",
    "arch.dma_issue_latency": "nonneg",
    "arch.relayout_efficiency": "fraction",
    "arch.relayout_lane_efficiency": "fraction",
    "arch.small_kernel_floor_cycles": "nonneg",
    "arch.vmem_copy_efficiency": "fraction",
    "arch.vmem_slice_efficiency": "fraction",
    "arch.hbm_bandwidth": "positive",
    "arch.hbm_efficiency": "fraction",
    "arch.hbm_latency": "nonneg",
    "arch.hbm_gib": "positive",
    "arch.vmem_bytes": "positive",
    "arch.vmem_bandwidth_mult": "positive",
    "arch.host_bandwidth": "positive",
    "arch.host_latency": "nonneg",
    # --- IciConfig --------------------------------------------------------
    "arch.ici.topology": "enum:torus3d,torus2d,mesh2d,ring",
    "arch.ici.link_bandwidth": "positive",
    "arch.ici.hop_latency": "nonneg",
    "arch.ici.launch_latency": "nonneg",
    "arch.ici.links_per_axis": "positive",
    "arch.ici.efficiency": "fraction",
    "arch.ici.dcn_bandwidth": "positive",
    "arch.ici.dcn_latency": "nonneg",
    "arch.ici.chips_per_slice": "nonneg",
    "arch.ici.dcn_nics_per_slice": "nonneg",
    "arch.ici.dcn_hop_bandwidth": "nonneg",
    "arch.ici.dcn_hop_latency": "nonneg",
    "arch.ici.dcn_oversubscription": "positive",
    "arch.ici.network_mode": "enum:analytic,detailed",
    "arch.ici.packet_bytes": "positive",
    # --- SimConfig --------------------------------------------------------
    "kernel_window": "positive",
    "stat_sample_cycles": "positive",
    "deadlock_cycles": "positive",
    "default_loop_trip_count": "positive",
    "dvfs_scale": "positive",
    "resume_kernel": "nonneg",
    "checkpoint_kernel": "nonneg",
    "resume_op": "nonneg",
    "checkpoint_op": "nonneg",
}


# ---------------------------------------------------------------------------
# Overlay / composition
# ---------------------------------------------------------------------------


def _overlay_dataclass(obj: Any, updates: dict[str, Any]) -> Any:
    """Return a copy of frozen dataclass ``obj`` with ``updates`` applied.
    Nested dataclasses accept nested dicts."""
    kw: dict[str, Any] = {}
    valid = {f.name: f for f in fields(obj)}
    for key, val in updates.items():
        if key not in valid:
            raise KeyError(
                f"unknown config key {key!r} for {type(obj).__name__}; "
                f"valid: {sorted(valid)}"
            )
        cur = getattr(obj, key)
        if dataclasses.is_dataclass(cur) and isinstance(val, dict):
            kw[key] = _overlay_dataclass(cur, val)
        elif isinstance(cur, dict) and isinstance(val, dict):
            merged = dict(cur)
            merged.update(val)
            kw[key] = merged
        else:
            kw[key] = val
    return dataclasses.replace(obj, **kw)


def overlay(config: Any, *layers: dict[str, Any]) -> Any:
    """Apply overlay dicts in order — the ``append_gpgpusim_config`` pattern
    (later layers win)."""
    for layer in layers:
        config = _overlay_dataclass(config, layer)
    return config


def parse_flag_file(path: str | Path) -> dict[str, Any]:
    """Parse a reference-style flag file (``-key value`` lines, ``#``/``//``
    comments) into an overlay dict.  Dotted keys reach nested configs:
    ``-arch.ici.link_bandwidth 9e10``."""
    updates: dict[str, Any] = {}
    for raw in Path(path).read_text().splitlines():
        line = raw.strip()
        if not line or line.startswith("#") or line.startswith("//"):
            continue
        if not line.startswith("-"):
            continue
        key, _, val = line[1:].partition(" ")
        val = val.strip()
        parsed: Any
        try:
            parsed = json.loads(val)
        except (json.JSONDecodeError, ValueError):
            parsed = val
        node = updates
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = parsed
    return updates


def tuned_overlay_path(arch_name: str) -> Path | None:
    """Locate the committed tuner overlay for an arch, if one exists.

    The tuner (``tpusim.harness.tuner``) writes silicon-fitted parameters
    to ``configs/<arch>.tuned.flags`` — the analogue of the reference's
    ``tested-cfgs`` produced by ``util/tuner/tuner.py:23-67`` and
    re-validated every CI run.  ``$TPUSIM_TUNED_DIR``, when set, is the
    EXCLUSIVE source (tests point it at an empty dir to isolate from repo
    artifacts); otherwise the repo-root ``configs/`` directory is used."""
    import os

    env = os.environ.get("TPUSIM_TUNED_DIR")
    base = (
        Path(env) if env
        else Path(__file__).resolve().parents[2] / "configs"
    )
    p = base / f"{arch_name.lower()}.tuned.flags"
    if p.is_file():
        return p
    # no silicon of this generation was ever measured here: fall back to
    # the cross-generation derivation (silicon-calibrated transferable
    # fractions/cycle-counts of the shared TensorCore design applied over
    # this generation's published absolutes — tpusim.timing.derive)
    d = base / f"{arch_name.lower()}.derived.flags"
    return d if d.is_file() else None


def load_config(
    base: "SimConfig | None" = None,
    *,
    arch: str | None = None,
    overlays: list[dict[str, Any] | str | Path] | None = None,
    tuned: bool = True,
) -> SimConfig:
    """Compose a SimConfig: named arch preset + the committed tuner
    overlay for that arch (when present and ``tuned=True``) + overlay
    dicts / flag files / JSON files, in order.  Explicit overlays win
    over the tuned values."""
    from tpusim_torch.timing.arch import arch_preset

    cfg = base or SimConfig()
    if arch is not None:
        cfg = dataclasses.replace(cfg, arch=arch_preset(arch))
        if tuned:
            tp = tuned_overlay_path(arch)
            if tp is not None:
                cfg = overlay(cfg, parse_flag_file(tp))
    for item in overlays or []:
        if isinstance(item, (str, Path)):
            p = Path(item)
            if p.suffix == ".json":
                layer = json.loads(p.read_text())
            else:
                layer = parse_flag_file(p)
        else:
            layer = item
        cfg = overlay(cfg, layer)
    return cfg
