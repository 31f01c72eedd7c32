#!/usr/bin/env python3
"""Design probe for kernel A's multi-RHS form (DIA SpMM,
``csrc/dia_spmv.cu``) on one NVIDIA GPU:

    python3 tools/torch_dia_spmm_probe.py --out OUT_DIR/dia_spmm_probe.json

On ``poisson_2d(g)`` for g in 1024 and 2048, f32 and f64, m = 16, 80 and
160, both layouts: the port's kernel under the geometry
``spmv_dia._dia_spmm_plan`` picks and under every other geometry the
launcher takes (column-major: vector lanes (G, 1) for G in {1, 2, 4, 8}
that cover m, (8, C) for C in {2, 3, 4}, the widest scalar group;
plane-major: 1, 2, 4 planes a thread); the source rebuilt with one row a
thread at every chunk count and with two (``kTwoRowChunks`` 0 and 5; the
latter stages four diagonals at a time, so that its tile fits 48 KB) at
(8, C) for C in {1, ..., 4}; and cuSPARSE SpMM (``@`` on a
``torch.sparse_csr_tensor``, X row-major).  Each time is the median of 24
calls from CUDA events, L2 flushed before each.  Every result must be
bitwise the plan's (and, at g = 1024, every column bitwise kernel A's);
the probe fails otherwise.  Bytes bound: the diagonals, X and Y once over
3.35 TB/s.  ``-Xptxas -v`` of the source is written beside the output.

Prints the card's name and power limit first.  Needs a CUDA device and
nvcc; imports no JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
import tempfile
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
HBM_BYTES_PER_S = 3.35e12
RULE_LINE = "constexpr int kTwoRowChunks = 2;"
CHUNK_LINE = "constexpr int kDiagChunk = 8;"


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=Path, required=True)
    ap.add_argument("--grids", type=int, nargs="+", default=[1024, 2048])
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_dia_spmm_probe: no CUDA device")
    sys.path.insert(0, str(ROOT))
    from sparse_linear_tpu_torch.formats.structured import csr_to_dia
    from sparse_linear_tpu_torch.kernels import _build, spmv_dia
    from sparse_linear_tpu_torch.utils.grids import poisson_2d

    card = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    args.out.parent.mkdir(parents=True, exist_ok=True)

    src = _build._PKG / "csrc" / "dia_spmv.cu"
    text = src.read_text()
    for line in (RULE_LINE, CHUNK_LINE):
        if line not in text:
            raise SystemExit(f"torch_dia_spmm_probe: {line!r} not in {src}")
    nvcc = _build.find_nvcc()
    tmp = Path(tempfile.mkdtemp(prefix="dia_spmm_probe_"))
    procs = {"ptxas": subprocess.Popen(
        [nvcc, *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o",
         str(tmp / "v.o"), str(src)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)}
    # the rule's alternatives: one row a thread at every chunk count, and
    # two rows at every chunk count (the shared tile then doubles at one
    # chunk: stage half the diagonals at a time to stay within 48 KB)
    for rows, rule, chunk in ((1, 0, 8), (2, 5, 4)):
        s = tmp / f"rows{rows}.cu"
        s.write_text(text.replace(
            RULE_LINE, f"constexpr int kTwoRowChunks = {rule};").replace(
                CHUNK_LINE, f"constexpr int kDiagChunk = {chunk};"))
        procs[rows] = subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-shared", "-o",
             str(tmp / f"rows{rows}.so"), str(s)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    lib = _build.load_library()
    outs = {k: p.communicate()[0] for k, p in procs.items()}
    for k, p in procs.items():
        if p.returncode:
            raise SystemExit(f"nvcc {k} failed:\n{outs[k][-4000:]}")
    (args.out.parent / "dia_spmm_ptxas.txt").write_text(outs["ptxas"])
    libs = {"rule": lib}
    for rows in (1, 2):
        v = ctypes.CDLL(str(tmp / f"rows{rows}.so"))
        for name, argtypes in _build._SIGNATURES.items():
            if name.startswith("slt_dia"):
                getattr(v, name).argtypes = argtypes
                getattr(v, name).restype = ctypes.c_int
        libs[rows] = v

    flush_buf = torch.empty(64 * 2**20, dtype=torch.int32, device=dev)

    def median_ms(f, reps=24):
        for _ in range(3):
            f()
        events = []
        for _ in range(reps):
            flush_buf.zero_()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            f()
            e.record()
            events.append((s, e))
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in events)

    def launcher(lib_, a, x, y, planes, vec, lanes, chunks):
        fn = (lib_.slt_dia_spmm_f32 if a.data.dtype == torch.float32
              else lib_.slt_dia_spmm_f64)
        nr, nc = a.shape
        m = x.shape[0] if planes else x.shape[1]
        ptrs = (a.data.data_ptr(), a.offsets_tensor.data_ptr(), x.data_ptr(),
                y.data_ptr())
        stream = torch.cuda.current_stream(dev).cuda_stream

        def call():
            code = fn(*ptrs, len(a.offsets), nr, nc, m, int(planes),
                      int(vec), lanes, chunks, 0, stream)
            if code:
                raise RuntimeError(f"launch ({planes}, {vec}, {lanes}, "
                                   f"{chunks}): code {code}")
        return call

    rows_out = []
    for g in args.grids:
        n = g * g
        for dtype in (torch.float32, torch.float64):
            csr = poisson_2d(g, dtype=dtype, device=dev)
            a = csr_to_dia(csr)
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", UserWarning)
                lib_a = torch.sparse_csr_tensor(
                    csr.indptr.to(torch.int32), csr.indices.to(torch.int32),
                    csr.data, csr.shape)
            del csr
            item = a.data.element_size()
            vx = 16 // item
            gen = torch.Generator(device=dev).manual_seed(g + item)
            for m in (16, 80, 160):
                x = torch.randn((n, m), dtype=dtype, device=dev,
                                generator=gen)
                xp = x.T.contiguous()
                nbytes = (len(a.offsets) * n + 2 * n * m) * item
                bound = nbytes / HBM_BYTES_PER_S * 1e3
                ref = spmv_dia.dia_spmm_kernel(a, x)
                refp = spmv_dia.dia_spmm_planes_kernel(a, xp)
                torch.cuda.synchronize()
                if g == 1024:
                    cols = all(torch.equal(ref[:, t], c) and
                               torch.equal(refp[t], c) for t in range(m)
                               for c in (spmv_dia.dia_spmv_kernel(
                                   a, x[:, t].contiguous()),))
                    if not cols:
                        raise SystemExit(f"g={g} {dtype} m={m}: a column "
                                         "differs from kernel A")
                lib_ms = median_ms(lambda: lib_a @ x)
                plan = spmv_dia._dia_spmm_plan(m, item, True, False)
                units = -(-m // vx)
                geoms = [(True, G, 1) for G in (1, 2, 4, 8) if G >= units]
                geoms += [(True, 8, C) for C in range(2, 5) if (8, C) != plan]
                geoms += [(False, 32 if item == 4 else 16, 1)]
                if (True, *plan) not in geoms:
                    geoms.insert(0, (True, *plan))
                cases = [("column-major", "rule", geo) for geo in geoms]
                cases += [("column-major", r, (True, 8, C)) for r in (1, 2)
                          for C in range(1, 5)]
                tp_plan = spmv_dia._dia_spmm_plan(m, item, False, True)
                cases += [("plane-major", "rule", (False, 1, tp))
                          for tp in (1, 2, 4)]
                for layout, r, (vec, lanes, chunks) in cases:
                    planes = layout == "plane-major"
                    y = torch.full_like(refp if planes else ref, float("nan"))
                    call = launcher(libs[r], a, xp if planes else x, y,
                                    planes, vec, lanes, chunks)
                    call()
                    torch.cuda.synchronize()
                    same = torch.equal(y, refp if planes else ref)
                    if not same:
                        raise SystemExit(
                            f"g={g} {dtype} m={m} {layout} rows={r} "
                            f"({vec}, {lanes}, {chunks}) differs")
                    ms = median_ms(call)
                    chosen = (r == "rule" and (
                        (planes and (lanes, chunks) == tp_plan)
                        or (not planes and vec and (lanes, chunks) == plan)))
                    rows_out.append({
                        "g": g, "dtype": str(dtype).replace("torch.", ""),
                        "m": m, "layout": layout, "rows_a_thread": r,
                        "vector": vec, "lanes": lanes, "chunks": chunks,
                        "plan": chosen, "ms": ms, "bound_ms": bound,
                        "bound_share": bound / ms, "library_ms": lib_ms})
                    print(f"[{card}] poisson_2d({g}) {dtype} m={m} {layout} "
                          f"rows a thread {r} (vector {vec}, lanes {lanes}, "
                          f"chunks {chunks}){' PLAN' if chosen else ''}: "
                          f"{ms:.4f} ms, bound {bound:.4f} ms "
                          f"({bound / ms:.1%}), cuSPARSE {lib_ms:.4f} ms",
                          flush=True)
                del x, xp, ref, refp, y
            del a, lib_a
            torch.cuda.empty_cache()
    args.out.write_text(json.dumps({"card": card, "readings": rows_out},
                                   indent=1))
    print(json.dumps({"ok": True, "card": card}))


if __name__ == "__main__":
    main()
