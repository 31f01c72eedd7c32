"""Spectrum slicing with FEAST on a contour sharded over the cards: the
``feast_slices`` windows, each through ``eigsh(..., mesh=card_mesh(chips,
("cp",)))``, so that every card factors and solves its share of the
contour nodes (two of eight on four cards) and the quadrature sums are
psum'd onto card 0, where the subspace lives.

Set-up: the operator from triples (``from_triples``, CSR) on card 0, and
one cold ``eigsh`` of the lowest window [0, edge 1), which pays the port's
``analyze`` once and sends the pattern to the other cards; then every
card's allocator peak is reset.  Request i: the window [edge i+1, edge
i+2), its random start drawn from (seed, i), returned once every card has
finished; a window that does not run sharded with its nodes resident on
every card (a streaming shard refactors every loop) counts as failed.  The
check is ``feast_slices``'s: count and values against the closed-form
spectrum, residuals and orthonormality of a sample of windows' vectors.
On the CPU (the tests' tiny runs) the shards share the CPU.

Per window it counts, from ``pipeline.last_run["cards"]`` and
``["exchange_bytes"]`` where the port fills them: the slowest card's
factor seconds, the sum of the cards' factor seconds over the wall time of
the factorization, the bytes copied between cards, and the largest
allocator peak of any card.
"""

from __future__ import annotations

import dataclasses
import math
from types import SimpleNamespace

import numpy as np
import torch

from spbench.drivers.feast_slices import check, slice_edges
from spbench.harness import sampled, substream, sync
from spbench.operators import generator
from spbench.reference import spectrum


def setup(ctx):
    wl, cfg, run = ctx.workload, ctx.config, ctx.run
    with run.stage("import"):
        from sparse_linear_tpu_torch.dist import card_mesh
        from sparse_linear_tpu_torch.eig import feast, pipeline
        from sparse_linear_tpu_torch.formats.matrix import from_triples
    grid = list(cfg["grid"])
    n = math.prod(grid)
    lam = spectrum.eigenvalues(grid)
    on_card = ctx.device.type == "cuda"
    mesh = card_mesh(int(cfg["chips"]), ("cp",),
                     device=None if on_card else "cpu")
    st = SimpleNamespace(
        seed=ctx.seed, device=ctx.device, grid=grid, n=n, lam=lam,
        gen=generator(cfg), mesh=mesh,
        cards=list(dict.fromkeys(mesh.shards("cp"))),
        m0=int(wl["m0"]), rate=float(wl["check_rate"]), run=run,
        edges=slice_edges(lam, int(wl["per_window"]), int(wl["slack"]),
                          int(wl["windows"]) + 1),
        params=feast.FeastParams(
            tol=float(cfg["tolerance"]), dims=tuple(grid),
            backend="multifrontal",
            contour_points=int(wl["contour_points"])),
        feast=feast, pipeline=pipeline, answers=[], vectors={},
        windows=[], log=ctx.log)
    with run.stage("operator"):
        rows, cols, vals = st.gen.triples(grid, torch.float64, ctx.device)
        st.a = from_triples((n, n), rows, cols, vals.to(ctx.dtype)).tocsr()
        del rows, cols, vals
    with run.stage("cold_window"):
        res = feast.eigsh(st.m0, (0.0, st.edges[0]), st.a, st.params,
                          mesh=mesh)
        _sync_cards(st)
    last = pipeline.last_run
    run.spans["feast.analyze"] = [(last["analyze_s"], False)]
    ctx.log(f"feast_cards: n {n}, {mesh.layout()}, lowest window "
            f"{res.n_found} pairs in {res.iterations} loops, contour "
            f"{last['mode']} ({last['why']}), analyze "
            f"{last['analyze_s']:.4f} s, {ctx.dtype}")
    if on_card:
        for d in st.cards:
            torch.cuda.reset_peak_memory_stats(d)
    return st


def _sync_cards(st) -> None:
    for d in st.cards:
        sync(d)


def prepare(st, i: int) -> None:
    st.window = (st.edges[i + 1], st.edges[i + 2])
    st.params_i = dataclasses.replace(
        st.params, seed=substream(st.seed, i + 1))


def _count_cards(st, last) -> str:
    """Count what ``last_run`` holds of the cards; the window's line."""
    cards = last.get("cards")
    if not cards:
        return ""
    factor = [c["factor_s"] for c in cards]
    st.run.count("feast.card_factor_s", max(factor))
    if last["factor_s"] > 0 and sum(factor) > 0:
        st.run.count("feast.card_overlap", sum(factor) / last["factor_s"])
    st.run.count("feast.exchange_gb", last["exchange_bytes"] / 1e9)
    st.run.count("device_peak_gb.cards",
                 max(c["peak_bytes"] for c in cards) / 1e9)
    return "; cards " + ", ".join(
        f"{c['device']} {c['nodes']} {c['mode']} factor "
        f"{c['factor_s']:.3f} filter {c['filter_s']:.3f} s peak "
        f"{c['peak_bytes'] / 1e9:.2f} GB" for c in cards) + (
        f"; exchanged {last['exchange_bytes']} B")


def serve(st, i: int) -> bool:
    with st.run.span("eig"):
        res = st.feast.eigsh(st.m0, st.window, st.a, st.params_i,
                             mesh=st.mesh)
        _sync_cards(st)
    last = st.pipeline.last_run
    resident = (last["mode"] == "sharded"
                and last["shard_mode"] in ("batched", "per-node"))
    st.windows.append(
        f"{i}: {len(last['loops'])} loops {st.run.spans['eig'][-1][0]:.3f} "
        f"s (factor {last['factor_s']:.3f}) {last['mode']} "
        f"{last['shard_mode']}" + _count_cards(st, last))
    st.answers.append((i, st.window, np.asarray(res.values)))
    if sampled(st.seed, i, st.rate):
        st.vectors[i] = (res.values, res.vectors)
    st.last = (i, (res.values, res.vectors))
    return res.info == st.feast.INFO_OK and resident


def release(st) -> None:
    st.pipeline.clear_pipeline_cache()
    st.a = None
    st.log("feast_cards: windows " + "; ".join(st.windows))
