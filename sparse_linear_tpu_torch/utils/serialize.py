"""Checkpoint / resume for solver and eigensolver artifacts.

Counterpart of :mod:`sparse_linear_tpu.utils.serialize`, with the same six
functions and the same files: numpy ``.npz`` archives
(``np.savez_compressed``, no pickle) under the JAX package's keys, so a
file written by either package loads in the other, the WELL packing aside.

* Factors persist as flat archives of their dense blocks.  Dense factors
  hold torch's 1-based LAPACK pivots (``solve.api.Factors``); the files
  hold the JAX package's 0-based ones (``piv - 1`` on save, ``+ 1`` on
  load).
* A multifrontal symbolic analysis persists as its *recipe* (elimination
  order and relaxation parameters): on restore, ``analyze(mat, perm=...)``
  re-derives the identical schedule on ``mat``'s device, checked against
  the saved pattern key.
* FEAST warm-start subspaces persist as plain arrays, and load as tensors
  for ``eig.feast.eigsh(..., guess=...)``.
* The port's WELL is a sliced ELL (``formats/well.py``), not the JAX
  package's chunk packing, so ``save_well`` writes its own fields under
  its own ``kind``, which the JAX package's ``load_well`` refuses.
  ``load_well`` reads both: a JAX-written packing is decoded and repacked
  as ``interop.jax_state.from_arrays("well", ...)`` does.

Loads go to ``device=``, by default the card (``dtypes.default_device``);
multifrontal factors go to the device of the matrix given.
"""

from __future__ import annotations

import numpy as np
import torch

from sparse_linear_tpu_torch.dtypes import default_device
from sparse_linear_tpu_torch.solve import api as solve_api
from sparse_linear_tpu_torch.solve import multifrontal as mf

__all__ = [
    "save_factors",
    "load_factors",
    "save_subspace",
    "load_subspace",
    "save_well",
    "load_well",
]

# ``kind`` of the port's WELL files; the JAX package's files say "well"
WELL_KIND = "sliced_well"


def _host(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().resolve_conj().cpu().numpy()
    return np.asarray(t)


def _matrices(arr: np.ndarray, device) -> torch.Tensor:
    """A stack of matrices on ``device``, laid out column-major as
    torch.linalg leaves the factors it returns, so that a solve on loaded
    factors runs the same BLAS paths as on the saved ones, bitwise."""
    return torch.as_tensor(np.ascontiguousarray(np.swapaxes(arr, -1, -2)),
                           device=device).mT


def save_factors(path, factors):
    """Persist a Factors artifact (dense or multifrontal) to ``path``."""
    if factors.backend == "dense":
        lu, piv = factors.payload
        payload = {
            "backend": "dense",
            "n": factors.n,
            "lu": _host(lu),
            "piv": (_host(piv) - 1).astype(np.int32),
        }
        if factors.batch is not None:
            payload["batch"] = np.asarray(factors.batch, dtype=np.int64)
        np.savez_compressed(path, **payload)
        return
    if factors.backend == "multifrontal":
        sym = factors.symbolic
        payload = {
            "backend": "multifrontal",
            "n": sym.n,
            "perm": sym.perm,
            "relax_small": sym.relax[0],
            "relax_frac": sym.relax[1],
            "pattern_key": np.asarray(sym.pattern_key, dtype=np.int64),
            "bucket_ids": np.asarray(sorted(factors.blocks.keys())),
            "kind": factors.kind,
        }
        if factors.batch is not None:
            payload["batch"] = np.asarray(factors.batch, dtype=np.int64)
        for bidx, blk in factors.blocks.items():
            for name, arr in blk.items():
                payload[f"b{bidx}__{name}"] = _host(arr)
        # the JAX package's diagnostic count is int32
        payload["b-1__n_flag"] = payload["b-1__n_flag"].astype(np.int32)
        np.savez_compressed(path, **payload)
        return
    raise TypeError(f"unsupported factors backend: {factors.backend}")


def load_factors(path, mat=None, device=None):
    """Restore a Factors artifact.  Multifrontal restore requires ``mat``
    (same pattern as at save time) to re-derive the symbolic schedule, and
    puts the factors on ``mat``'s device; dense factors go to ``device``
    (by default the card)."""
    with np.load(path, allow_pickle=False) as z:
        backend = str(z["backend"])
        if backend == "dense":
            dev = default_device(device)
            return solve_api.Factors(
                payload=(_matrices(z["lu"], dev),
                         torch.as_tensor(z["piv"] + 1, device=dev)),
                n=int(z["n"]),
                backend="dense",
                batch=int(z["batch"]) if "batch" in z else None,
            )
        if backend == "multifrontal":
            if mat is None:
                raise ValueError(
                    "multifrontal restore needs the matrix (same pattern) to "
                    "re-derive the symbolic schedule"
                )
            n = int(z["n"])
            if (n == 2 * mat.shape[0] and mat.dtype.is_complex
                    and not np.iscomplexobj(z["b0__lu"])):
                raise ValueError(
                    "these are real factors of the 2n x 2n embedding of a "
                    "complex matrix (the JAX package's solve/complex_embed); "
                    "the port factors complex matrices natively: factor "
                    "this matrix again")
            sym = mf.analyze(
                mat,
                perm=z["perm"],
                relax_small=int(z["relax_small"]),
                relax_frac=float(z["relax_frac"]),
            )
            if tuple(int(v) for v in z["pattern_key"]) != sym.pattern_key:
                raise ValueError(
                    "saved factors do not match this matrix pattern"
                )
            dev = mat.data.device
            kind = str(z["kind"]) if "kind" in z else "lu"

            def leaf(key):
                return torch.as_tensor(z[key], device=dev)

            def matrices(key):
                return _matrices(z[key], dev)

            blocks = {}
            for bidx in z["bucket_ids"].tolist():
                if int(bidx) == -1:  # diagnostics pseudo-bucket (n_flag)
                    blocks[-1] = {"n_flag": leaf("b-1__n_flag").long()}
                    continue
                if int(bidx) == -2:  # equilibration pseudo-bucket
                    blocks[-2] = {"rscale": leaf("b-2__rscale")}
                    continue
                blk = {"lu": matrices(f"b{bidx}__lu"),
                       "perm": leaf(f"b{bidx}__perm"),
                       "g12": matrices(f"b{bidx}__g12")}
                # Cholesky: G21 = G12^H, a view as in MFFactors.to
                blk["g21"] = (blk["g12"].mH if kind == "cholesky"
                              else matrices(f"b{bidx}__g21"))
                blocks[int(bidx)] = blk
            return mf.MFFactors(
                sym, blocks, blocks[0]["lu"].dtype, kind=kind,
                batch=int(z["batch"]) if "batch" in z else None)
        raise ValueError(f"unknown backend in checkpoint: {backend}")


def save_subspace(path, result):
    """Persist a FEAST warm-start subspace (EigResult, or an (n, m0) tensor
    or array)."""
    subspace = getattr(result, "subspace", result)
    np.savez_compressed(path, subspace=_host(subspace))


def load_subspace(path, device=None):
    """The saved subspace as a tensor on ``device`` (by default the card),
    ready for ``eigsh(..., guess=...)``."""
    with np.load(path, allow_pickle=False) as z:
        return torch.as_tensor(z["subspace"], device=default_device(device))


def save_well(path, well):
    """Persist the port's WELL packing (``formats/well.py``), the SpMV
    analyze artifact, under the port's own ``kind``."""
    np.savez_compressed(
        path,
        kind=WELL_KIND,
        shape=np.asarray(well.shape, dtype=np.int64),
        c_max=well.c_max,
        fill=well.fill,
        slice_ptr=_host(well.slice_ptr),
        cols=_host(well.cols),
        vals=_host(well.vals),
    )


def load_well(path, device=None):
    """A WELL on ``device`` (by default the card) from the port's file, or
    from the JAX package's (its chunk planes decoded and repacked)."""
    from sparse_linear_tpu_torch.formats.well import WELL
    from sparse_linear_tpu_torch.interop.jax_state import from_arrays

    dev = default_device(device)
    with np.load(path, allow_pickle=False) as z:
        kind = str(z["kind"])
        shape = tuple(int(v) for v in z["shape"])
        if kind == "well":
            arrays = {n: z[n] for n in ("bases", "idx", "vals")}
            if "vals_im" in z.files:
                arrays["vals_im"] = z["vals_im"]
            return from_arrays("well", arrays, shape, device=dev)
        if kind != WELL_KIND:
            raise ValueError("not a WELL checkpoint")
        return WELL(
            slice_ptr=torch.as_tensor(z["slice_ptr"], device=dev),
            cols=torch.as_tensor(z["cols"], device=dev),
            vals=torch.as_tensor(z["vals"], device=dev),
            shape=shape,
            c_max=int(z["c_max"]),
            fill=float(z["fill"]),
        )
