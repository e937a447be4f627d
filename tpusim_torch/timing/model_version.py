"""Content hash of the timing model.

Port of ``tpusim/timing/model_version.py``.  The cache keys of
:mod:`tpusim_torch.perf.cache` (compiled columns and engine results) carry
a hash of the sources that define the timing model's predictions, so an
edit to any of them invalidates every entry built before it.  The files
hashed are the port's own.
"""

from __future__ import annotations

import hashlib
from pathlib import Path

__all__ = ["MODEL_FILES", "model_version"]

_REPO = Path(__file__).resolve().parents[2]

#: the files whose content defines the timing model's predictions: the
#: cost model, the schedule-walking engine, the config/arch presets, the
#: ICI models, and the committed tuned overlay that load_config applies
#: by default.  Paths are repo-relative.
MODEL_FILES: tuple[str, ...] = (
    "tpusim_torch/timing/cost.py",
    "tpusim_torch/timing/engine.py",
    "tpusim_torch/timing/config.py",
    "tpusim_torch/timing/arch.py",
    "tpusim_torch/ici/collectives.py",
    "tpusim_torch/ici/detailed.py",
    "tpusim_torch/ici/topology.py",
    "configs/v5e.tuned.flags",
)

#: per-root digest memo: the sources cannot change under a running process
_version_cache: dict[str, str] = {}


def model_version(repo_root: str | Path | None = None) -> str:
    """Short, stable digest of the timing model's sources (computed once
    per process per root).  Missing files hash as empty (a deleted overlay
    still changes the digest relative to a tree that had one)."""
    root = Path(repo_root) if repo_root is not None else _REPO
    key = str(root)
    cached = _version_cache.get(key)
    if cached is not None:
        return cached
    h = hashlib.sha256()
    for rel in MODEL_FILES:
        p = root / rel
        h.update(rel.encode())
        h.update(b"\0")
        h.update(p.read_bytes() if p.is_file() else b"")
        h.update(b"\0")
    return _version_cache.setdefault(key, h.hexdigest()[:16])
