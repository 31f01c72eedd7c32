"""The port's scale rehearsal (``tools/torch_multichip_scale.py``): on 16
CPU shards and the 24**3 Poisson operator, the x elements a shard receives
equal the JAX package's record (``MULTICHIP_SCALE.json``) format by
format, every product is within 1e-10 of scipy's, and the committed
``MULTICHIP_SCALE_TORCH.json`` holds the same counts."""

import importlib.util
import json
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parent.parent


def _tool():
    spec = importlib.util.spec_from_file_location(
        "torch_multichip_scale", ROOT / "tools" / "torch_multichip_scale.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_scale_rehearsal_ships_the_jax_counts(tmp_path):
    mod = _tool()
    out = mod.scale_rehearsal(16, 24, device="cpu")
    jax_rec = json.loads((ROOT / "MULTICHIP_SCALE.json").read_text())
    for key in ("n_devices", "operator", "n", "nnz", "rows_per_device",
                "allgather_elements_per_device"):
        assert out[key] == jax_rec[key], key
    assert out["formats"].keys() == jax_rec["formats"].keys()
    for name, rec in out["formats"].items():
        want = jax_rec["formats"][name]
        assert rec["exchange"] in ("halo", "window"), (name, rec)
        assert rec["shipped_elements_per_device"] == \
            want["shipped_elements_per_device"], name
        assert rec["vs_allgather"] == want["vs_allgather"], name
        assert rec["ok"] and rec["max_abs_err"] <= 1e-10, (name, rec)
    committed = json.loads((ROOT / "MULTICHIP_SCALE_TORCH.json").read_text())
    for name, rec in committed["formats"].items():
        assert rec["shipped_elements_per_device"] == \
            out["formats"][name]["shipped_elements_per_device"], name
        assert rec["ok"] and rec["max_abs_err"] <= 1e-10, (name, rec)
    path = tmp_path / "scale.json"
    mod.main(["--shards", "16", "--nx", "24", "--device", "cpu", "--out",
              str(path)])
    assert json.loads(path.read_text())["formats"].keys() == \
        out["formats"].keys()
