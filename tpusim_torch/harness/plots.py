"""Correlation plots + HTML report (port of ``tpusim/harness/plots.py``).

The rebuild of the reference's plot layer (``util/plotting/
plot-correlation.py``: per-stat sim-vs-HW scatter with error/correlation
summaries published as HTML by CI, ``Jenkinsfile:83-97``).  plotly is not
in this image, so the scatter is rendered with matplotlib (Agg) and
embedded base64 into a single self-contained HTML file — same artifact
shape as the reference's ``correl-html/``.
"""

from __future__ import annotations

import base64
import html
import io
import math
from pathlib import Path

from tpusim_torch.harness.correlate import CorrelationPoint

__all__ = ["correlation_stats", "write_correlation_report"]


def correlation_stats(points: list[CorrelationPoint]) -> dict[str, float]:
    """Summary stats over the suite — the error/correlation block the
    reference prints per card (``plot-correlation.py`` err/corr lines)."""
    pts = [p for p in points if p.real_seconds > 0 and p.sim_seconds > 0]
    if not pts:
        return {"n": 0}
    mean_abs = sum(p.abs_error_pct for p in pts) / len(pts)
    max_abs = max(p.abs_error_pct for p in pts)
    # Pearson correlation of log-times (the quantity that matters across
    # workloads spanning orders of magnitude)
    xs = [math.log10(p.real_seconds) for p in pts]
    ys = [math.log10(p.sim_seconds) for p in pts]
    n = len(pts)
    mx, my = sum(xs) / n, sum(ys) / n
    cov = sum((x - mx) * (y - my) for x, y in zip(xs, ys))
    vx = sum((x - mx) ** 2 for x in xs)
    vy = sum((y - my) ** 2 for y in ys)
    out = {
        "n": n,
        "mean_abs_error_pct": mean_abs,
        "max_abs_error_pct": max_abs,
    }
    # undefined for <2 points or zero variance: omit rather than fake 1.0
    if n >= 2 and vx > 0 and vy > 0:
        out["log_correlation"] = cov / math.sqrt(vx * vy)
    return out


def _scatter_png(points: list[CorrelationPoint]) -> bytes:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(6.5, 6))
    xs = [p.real_seconds * 1e6 for p in points]
    ys = [p.sim_seconds * 1e6 for p in points]
    lo = min(xs + ys) * 0.5
    hi = max(xs + ys) * 2.0
    ax.plot([lo, hi], [lo, hi], "k--", lw=1, label="y = x")
    ax.plot([lo, hi], [lo * 1.15, hi * 1.15], ":", color="gray", lw=0.8)
    ax.plot([lo, hi], [lo * 0.85, hi * 0.85], ":", color="gray", lw=0.8,
            label="±15% (north star)")
    ax.scatter(xs, ys, s=48, zorder=3)
    for p, x, y in zip(points, xs, ys):
        ax.annotate(f"{p.name}\n{p.error_pct:+.1f}%", (x, y),
                    textcoords="offset points", xytext=(6, 4), fontsize=7)
    ax.set_xscale("log")
    ax.set_yscale("log")
    ax.set_xlim(lo, hi)
    ax.set_ylim(lo, hi)
    ax.set_xlabel("silicon time per step (µs)")
    ax.set_ylabel("simulated time per step (µs)")
    ax.set_title("tpusim: simulated vs silicon")
    ax.legend(loc="upper left", fontsize=8)
    ax.grid(True, which="both", alpha=0.25)
    buf = io.BytesIO()
    fig.savefig(buf, format="png", dpi=130, bbox_inches="tight")
    plt.close(fig)
    return buf.getvalue()


def write_correlation_report(
    points: list[CorrelationPoint],
    out_dir: str | Path,
    title: str = "tpusim correlation report",
) -> Path:
    """Write ``correl.html`` (self-contained: embedded PNG + table) and
    ``correl.png``; returns the HTML path."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    dropped = [
        p for p in points if p.real_seconds <= 0 or p.sim_seconds <= 0
    ]
    points = [
        p for p in points if p.real_seconds > 0 and p.sim_seconds > 0
    ]
    stats = correlation_stats(points)
    png = _scatter_png(points) if points else b""
    if png:
        (out / "correl.png").write_bytes(png)

    # curated understood deviations (known.correlation.outliers.list slot):
    # annotated in the table, never removed from the stats
    try:
        from tpusim_torch.harness.correl_ops import (
            load_known_outliers, match_known_outlier,
        )

        outliers = load_known_outliers()
        known = {
            p.name: match_known_outlier(
                outliers, p.name, abs_error_pct=p.abs_error_pct,
            )
            for p in points
        }
    except Exception:
        known = {}
    unexplained = [
        p.abs_error_pct for p in points if not known.get(p.name)
    ]

    def _row(p: CorrelationPoint) -> str:
        reason = known.get(p.name)
        note = (
            f'<br><small title="{html.escape(reason)}">known outlier: '
            f"{html.escape(reason[:60])}…</small>" if reason else ""
        )
        style = ' style="background:#fff6e0"' if reason else ""
        return (
            "<tr{style}><td>{name}{note}</td><td align=right>{real:.1f}"
            "</td><td align=right>{sim:.1f}</td>"
            "<td align=right>{err:+.2f}%</td><td align=right>{src}</td>"
            "<td align=right>{fl:.3g}</td><td align=right>{hb:.3g}</td>"
            "</tr>".format(
                style=style, name=html.escape(p.name), note=note,
                real=p.real_seconds * 1e6, sim=p.sim_seconds * 1e6,
                err=p.error_pct, src=html.escape(p.real_source),
                fl=p.flops, hb=p.hbm_bytes,
            )
        )

    rows = "\n".join(
        _row(p) for p in sorted(points, key=lambda p: -p.abs_error_pct)
    )
    corr = stats.get("log_correlation")
    summary = (
        "<p><b>{n}</b> workloads — mean |error| "
        "<b>{mean:.2f}%</b>, max |error| {mx:.2f}%, "
        "log-time correlation {corr}{excl}</p>".format(
            n=stats["n"], mean=stats["mean_abs_error_pct"],
            mx=stats["max_abs_error_pct"],
            corr=f"{corr:.4f}" if corr is not None else "n/a",
            excl=(
                "; excluding known outliers: "
                f"<b>{sum(unexplained) / len(unexplained):.2f}%</b> "
                f"({len(unexplained)} workloads)"
                if unexplained and len(unexplained) != stats["n"] else ""
            ),
        )
        if stats.get("n") else "<p>no points</p>"
    )
    if dropped:
        summary += (
            "<p><b>dropped {} point(s)</b> with non-positive times: "
            "{}</p>".format(
                len(dropped),
                ", ".join(html.escape(p.name) for p in dropped),
            )
        )
    img_tag = (
        f'<img src="data:image/png;base64,'
        f'{base64.b64encode(png).decode()}">' if png else ""
    )
    doc = f"""<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>{html.escape(title)}</title>
<style>body{{font-family:sans-serif;margin:2em}}table{{border-collapse:
collapse}}td,th{{border:1px solid #ccc;padding:4px 10px}}</style></head>
<body>
<h1>{html.escape(title)}</h1>
{summary}
{img_tag}
<h2>per-workload</h2>
<table>
<tr><th>workload</th><th>silicon µs/step</th><th>sim µs/step</th>
<th>error</th><th>truth</th><th>flops/step</th><th>hbm B/step</th></tr>
{rows}
</table>
</body></html>
"""
    path = out / "correl.html"
    path.write_text(doc)
    return path
