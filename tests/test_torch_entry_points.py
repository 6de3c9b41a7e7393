"""The port's other entry points vs the JAX package: hyperopt (TPE and the
trial files), interpret (MCTS rationales), the SMILES writer and the SVG
depiction, the web app and the ``cli`` subcommands.

* ``TPE.suggest`` on fixed trial lists draws exactly what JAX's draws; a
  ``hyperopt(num_iters=2)`` writes the same trial parameters (seed 1: two
  start-up trials of hidden 700 and 400, which keeps the JAX run short);
* ``interpret`` from one JAX-written classifier checkpoint: the same
  rationales, scores within rtol 1e-5 (``band_precision="highest"``: FP32
  as JAX's CPU path);
* ``write_smiles``, ``extract_subgraph_smiles`` and ``depict_svg`` equal
  byte for byte on 50 SMILES of regression.csv;
* the web upload -> train -> predict flow through a live server on the
  CPU, its predictions equal to the port's ``make_predictions``;
* ``cli`` dispatch of hyperopt, interpret, ssl_pretrain, web and
  ``sklearn_*``.
"""

import csv
import http.client
import json
import os
import threading
import time
from http.server import ThreadingHTTPServer

import jax
import numpy as np
import pytest

from polymer_chemprop_tpu import hyperparameter_optimization as jax_hopt
from polymer_chemprop_tpu.chem import parse_smiles as jax_parse
from polymer_chemprop_tpu.chem.depict import depict_svg as jax_depict
from polymer_chemprop_tpu.chem.write import (
    extract_subgraph_smiles as jax_extract,
)
from polymer_chemprop_tpu.chem.write import write_smiles as jax_write
from polymer_chemprop_tpu.config import PredictConfig as JaxPredictConfig
from polymer_chemprop_tpu.config import TrainConfig as JaxTrainConfig
from polymer_chemprop_tpu.interpret import interpret as jax_interpret
from polymer_chemprop_tpu.models import init_model
from polymer_chemprop_tpu.train.trainer import build_model_config
from polymer_chemprop_tpu.utils.checkpoint import save_checkpoint
from polymer_chemprop_tpu_torch import cli
from polymer_chemprop_tpu_torch import hyperparameter_optimization as hopt
from polymer_chemprop_tpu_torch.chem import parse_smiles
from polymer_chemprop_tpu_torch.chem.depict import depict_svg
from polymer_chemprop_tpu_torch.chem.write import (
    extract_subgraph_smiles,
    write_smiles,
)
from polymer_chemprop_tpu_torch.config import PredictConfig, TrainConfig
from polymer_chemprop_tpu_torch.interpret import interpret
from polymer_chemprop_tpu_torch.train.make_predictions import make_predictions
from polymer_chemprop_tpu_torch.web.app import build_app
from test_torch_threads import torch_threads  # noqa: F401

DATA = os.path.join(os.path.dirname(__file__), "data")
REGRESSION = os.path.join(DATA, "regression.csv")


def _rows(path, n):
    with open(path) as f:
        return list(csv.reader(f))[:n + 1]


def _write_rows(path, rows):
    with open(path, "w", newline="") as f:
        csv.writer(f).writerows(rows)
    return str(path)


def _history(seed, n):
    rng = np.random.default_rng(seed)
    hist = []
    for i in range(n):
        params = {k: v[rng.integers(len(v))] for k, v in hopt.SPACE.items()}
        loss = None if i == 3 else float(rng.normal())
        hist.append({"params": params, "loss": loss})
    return hist


@pytest.mark.parametrize("n_trials", [0, 4, 12, 20])
def test_tpe_suggest_matches_jax(n_trials):
    assert hopt.SPACE == jax_hopt.SPACE
    history = _history(n_trials, n_trials)
    for seed in range(3):
        got = hopt.TPE(hopt.SPACE, seed=seed)
        want = jax_hopt.TPE(jax_hopt.SPACE, seed=seed)
        for _ in range(2):
            assert got.suggest(history) == want.suggest(history)


def test_hyperopt_writes_the_jax_trials(tmp_path):
    rows = _rows(REGRESSION, 32)
    data = _write_rows(tmp_path / "data.csv", rows)
    kw = dict(data_path=data, dataset_type="regression", epochs=1, seed=1,
              batch_size=32, num_workers=1, quiet=True)
    got = hopt.hyperopt(TrainConfig(save_dir=str(tmp_path / "port"),
                                    device="cpu", **kw), num_iters=2)
    want = jax_hopt.hyperopt(JaxTrainConfig(save_dir=str(tmp_path / "jax"),
                                            **kw), num_iters=2)
    trials = {k: [t["params"] for t in hopt.load_trials(
        str(tmp_path / k / "hyperopt_trials"))] for k in ("port", "jax")}
    assert len(trials["port"]) == 2
    assert trials["port"] == trials["jax"]
    assert [(p["hidden_size"], p["depth"]) for p in trials["port"]] == \
        [(700, 6), (400, 2)]
    assert np.isfinite(got["loss"]) and np.isfinite(want["loss"])
    with open(tmp_path / "port" / "hyperopt_trials" /
              "hyperopt_seeds.txt") as f:
        assert f.read().split() == ["1", "2"]


def test_interpret_matches_jax(tmp_path):
    tcfg = JaxTrainConfig(dataset_type="classification", hidden_size=32,
                          depth=3, ffn_hidden_size=32, target_columns=["t0"],
                          band_precision="highest")
    params = init_model(jax.random.PRNGKey(5), build_model_config(tcfg, 1))
    save_checkpoint(str(tmp_path / "ckpt" / "model.ckpt"), params,
                    tcfg.to_dict())
    rows = _rows(os.path.join(DATA, "classification.csv"), 3)
    test_csv = _write_rows(tmp_path / "interp.csv", [r[:1] for r in rows])
    kw = dict(property_id=1, rollout=3, max_atoms=12, min_atoms=4,
              prop_delta=0.0, writer=lambda line: None)
    got = interpret(PredictConfig(checkpoint_dir=str(tmp_path / "ckpt"),
                                  batch_size=10, device="cpu"),
                    test_csv, save_svg_dir=str(tmp_path / "svg"), **kw)
    want = jax_interpret(JaxPredictConfig(
        checkpoint_dir=str(tmp_path / "ckpt"), batch_size=10), test_csv,
        **kw)
    assert len(got) == len(want) == 3
    assert [(s, r) for s, _, r, _ in got] == [(s, r) for s, _, r, _ in want]
    assert any(r is not None for _, _, r, _ in got)
    for (_, score, _, rscore), (_, jscore, _, jrscore) in zip(got, want):
        np.testing.assert_allclose(score, jscore, rtol=1e-5)
        if rscore is not None:
            np.testing.assert_allclose(rscore, jrscore, rtol=1e-5)
    assert os.listdir(tmp_path / "svg")


def test_writer_and_depiction_match_jax():
    smiles = [r[0] for r in _rows(REGRESSION, 50)[1:]]
    assert len(smiles) == 50
    for s in smiles:
        mol, jmol = parse_smiles(s), jax_parse(s)
        assert write_smiles(mol) == jax_write(jmol)
        half = set(range(mol.n_atoms // 2 + 1))
        assert extract_subgraph_smiles(mol, half) == jax_extract(jmol, half)
        hl = sorted(half)[:3]
        assert depict_svg(mol, highlight_atoms=hl) == \
            jax_depict(jmol, highlight_atoms=hl)


def _request(port, method, path, fields=None):
    body, headers = None, {}
    if fields is not None:
        boundary = "XxX"
        parts = [f"--{boundary}\r\nContent-Disposition: form-data; "
                 f'name="{k}"\r\n\r\n'.encode()
                 + (v if isinstance(v, bytes) else str(v).encode())
                 + b"\r\n" for k, v in fields.items()]
        body = b"".join(parts) + f"--{boundary}--\r\n".encode()
        headers["Content-Type"] = f"multipart/form-data; boundary={boundary}"
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request(method, path, body=body, headers=headers)
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    return resp.status, data


def test_web_upload_train_predict_on_the_cpu(tmp_path):
    handler, state = build_app(str(tmp_path / "web"), device="cpu")
    assert state.device == "cpu"
    srv = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    port = srv.server_address[1]
    try:
        assert _request(port, "GET", "/")[0] == 200
        csv_bytes = "\n".join(",".join(r) for r in _rows(REGRESSION, 40))
        status, _ = _request(port, "POST", "/upload_data", {
            "name": "esol", "class": "regression",
            "file": csv_bytes.encode()})
        assert status == 303
        ds = state.db.datasets()[0]
        status, body = _request(port, "POST", "/train", {
            "dataset_id": ds["id"], "ckpt_name": "m1",
            "dataset_type": "regression", "epochs": 1})
        assert status == 200
        ckpt_id = json.loads(body)["ckpt_id"]
        deadline = time.time() + 120
        while time.time() < deadline:
            prog = json.loads(_request(port, "GET",
                                       f"/progress/{ckpt_id}")[1])
            if prog["state"] in ("done", "error"):
                break
            time.sleep(0.5)
        assert prog["state"] == "done", prog
        status, body = _request(port, "POST", "/predict", {
            "ckpt_id": ckpt_id, "smiles": "CCO\nc1ccccc1"})
        assert status == 200 and b"Predictions" in body
        smiles, rows = state.predict(ckpt_id, "CCO\nc1ccccc1")
        want = make_predictions(PredictConfig(
            checkpoint_dir=state.db.ckpt(ckpt_id)["save_dir"],
            device="cpu"), smiles=[["CCO"], ["c1ccccc1"]])
        assert smiles == ["CCO", "c1ccccc1"] and rows == want
    finally:
        srv.shutdown()


@pytest.mark.parametrize("cmd,module,fn", [
    ("hyperopt", "hyperparameter_optimization", "chemprop_hyperopt"),
    ("interpret", "interpret", "chemprop_interpret"),
    ("ssl_pretrain", "ssl", "ssl_pretrain_cli"),
    ("web", "web.app", "chemprop_web"),
])
def test_cli_dispatches_the_new_subcommands(monkeypatch, cmd, module, fn):
    import importlib
    mod = importlib.import_module(f"polymer_chemprop_tpu_torch.{module}")
    seen = []
    monkeypatch.setattr(mod, fn, seen.append)
    cli.main([cmd, "--device", "cpu"])
    assert seen == [["--device", "cpu"]]


def test_cli_device_flags_reach_the_entry_points(monkeypatch):
    from polymer_chemprop_tpu_torch import interpret as interp_mod
    from polymer_chemprop_tpu_torch import ssl
    from polymer_chemprop_tpu_torch.web import app
    seen = {}
    monkeypatch.setattr(app, "run_web", lambda *a: seen.update(web=a))
    cli.main(["web", "--port", "0", "--device", "cpu"])
    assert seen["web"] == ("127.0.0.1", 0, None, "cpu")
    monkeypatch.setattr(ssl, "ssl_pretrain", lambda c: seen.update(ssl=c))
    cli.main(["ssl_pretrain", "--data_path", "x.csv"])
    assert seen["ssl"].device == "cuda" and seen["ssl"].data_path == "x.csv"
    monkeypatch.setattr(interp_mod, "interpret",
                        lambda args, *a, **k: seen.update(interpret=args))
    cli.main(["interpret", "--data_path", "x.csv", "--checkpoint_dir", "d",
              "--device", "cpu"])
    assert seen["interpret"].device == "cpu"
    monkeypatch.setattr(hopt, "hyperopt",
                        lambda cfg, **k: seen.update(hyperopt=(cfg, k)))
    cli.main(["hyperopt", "--data_path", "x.csv", "--num_iters", "3",
              "--device", "cpu"])
    cfg, k = seen["hyperopt"]
    assert cfg.device == "cpu" and k["num_iters"] == 3


@pytest.mark.parametrize("cmd", ["sklearn_train", "sklearn_predict"])
def test_cli_dispatches_sklearn(monkeypatch, cmd):
    """Both subcommands reach their module's entry point, and ``--device``
    reaches the configuration (the default is cuda)."""
    from polymer_chemprop_tpu_torch import sklearn_predict, sklearn_train
    seen = []
    if cmd == "sklearn_train":
        monkeypatch.setattr(sklearn_train, "cross_validate",
                            lambda cfg, train_func: seen.append(
                                (cfg, train_func)))
        base = ["--data_path", "x.csv", "--model_type", "svm"]
    else:
        monkeypatch.setattr(sklearn_predict, "predict_sklearn", seen.append)
        base = ["--test_path", "x.csv", "--checkpoint_dir", "d"]
    cli.main([cmd, *base])
    cli.main([cmd, *base, "--device", "cpu"])
    if cmd == "sklearn_train":
        assert [c.device for c, _ in seen] == ["cuda", "cpu"]
        assert all(f is sklearn_train.run_sklearn and c.model_type == "svm"
                   for c, f in seen)
    else:
        assert [a.device for a in seen] == ["cuda", "cpu"]
        assert all(a.checkpoint_dir == "d" for a in seen)
