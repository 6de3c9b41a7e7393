"""Web GUI on the stdlib HTTP stack (reference chemprop/web: Flask routes
views.py home/train/predict/data/checkpoint CRUD), served with http.server
+ sqlite3: the port's copy of polymer_chemprop_tpu web/app.py. Training and
serving go through the port's ``cross_validate`` and ``make_predictions``
on ``AppState.device`` ("cuda" unless ``--device cpu`` is given); a failed
training run reports its error through ``/progress``.

Routes:
  GET  /                     overview (datasets, checkpoints)
  POST /upload_data          multipart CSV upload
  POST /train                start background training on a dataset
  GET  /progress/<ckpt_id>   JSON training status
  POST /predict              predict SMILES with a trained checkpoint
  POST /delete_data/<id>, /delete_ckpt/<id>
"""

from __future__ import annotations

import json
import os
import threading
import traceback
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from .db import WebDB

_PAGE = """<!DOCTYPE html>
<html><head><title>polymer-chemprop-tpu</title>
<style>
 body {{ font-family: sans-serif; margin: 2em; max-width: 60em; }}
 table {{ border-collapse: collapse; }} td, th {{ border: 1px solid #ccc; padding: 4px 8px; }}
 form {{ margin: 1em 0; padding: 1em; background: #f6f6f6; }}
</style></head>
<body>
<h1>polymer-chemprop-tpu</h1>
{body}
</body></html>"""


class AppState:
    def __init__(self, root: str, device: str = "cuda"):
        self.db = WebDB(root)
        self.root = root
        self.device = device
        self.progress = {}  # ckpt_id -> dict

    # ------------------------------------------------------------- training
    def start_training(self, dataset_id: int, ckpt_name: str,
                       dataset_type: str, epochs: int, ensemble_size: int,
                       user_id: int = 1):
        ds = next((d for d in self.db.datasets() if d["id"] == dataset_id),
                  None)
        if ds is None:
            raise ValueError("dataset not found")
        save_dir = os.path.join(self.root, "ckpts", ckpt_name)
        from ..data import get_data
        n = len(get_data(ds["path"]))
        ckpt_id = self.db.add_ckpt(ckpt_name, dataset_type, epochs,
                                   ensemble_size, n, save_dir,
                                   user_id=user_id)
        self.progress[ckpt_id] = {"state": "running", "epochs": epochs}

        def run():
            try:
                from ..config import TrainConfig
                from ..train.cross_validate import cross_validate
                cfg = TrainConfig(data_path=ds["path"],
                                  dataset_type=dataset_type,
                                  epochs=epochs, ensemble_size=ensemble_size,
                                  num_folds=1, save_dir=save_dir, quiet=True,
                                  device=self.device)
                mean, std = cross_validate(cfg)
                self.db.finish_ckpt(ckpt_id, {"mean_score": mean,
                                              "std_score": std,
                                              "metric": cfg.metric})
                self.progress[ckpt_id] = {"state": "done", "mean_score": mean}
            except Exception as e:  # surfaced through /progress
                traceback.print_exc()
                self.progress[ckpt_id] = {"state": "error", "error": str(e)}

        threading.Thread(target=run, daemon=True).start()
        return ckpt_id

    def predict(self, ckpt_id: int, smiles_text: str):
        ck = self.db.ckpt(ckpt_id)
        if ck is None or not ck["completed"]:
            raise ValueError("checkpoint not found or incomplete")
        from ..config import PredictConfig
        from ..train.make_predictions import make_predictions
        smiles = [[s.strip()] for s in smiles_text.splitlines() if s.strip()]
        preds, idx_map = make_predictions(
            PredictConfig(checkpoint_dir=ck["save_dir"], device=self.device),
            smiles=smiles,
            return_index_map=True)
        # align per-input rows: unparseable SMILES show a placeholder
        rows = [preds[idx_map[i]] if i in idx_map else ["Invalid SMILES"]
                for i in range(len(smiles))]
        return [s[0] for s in smiles], rows


class _BodyTooLarge(ValueError):
    """Request body exceeds the endpoint's cap — rendered as 413."""


def make_handler(state: AppState):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, body: str, code: int = 200,
                  ctype: str = "text/html"):
            data = body.encode()
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def _current_user(self) -> int:
            """Per-user flows (reference views.py scopes datasets and
            checkpoints by the selected user): the active user travels in
            a cookie, defaulting to the built-in 'default' user (id 1)."""
            cookie = self.headers.get("Cookie", "")
            for part in cookie.split(";"):
                k, _, v = part.strip().partition("=")
                if k == "user_id" and v.isdigit():
                    return int(v)
            return 1

        # request bodies are bounded here, in the shared read path (CSV
        # uploads are the largest legitimate payload)
        MAX_BODY = 64 * 1024 * 1024

        def _read_body(self, cap=MAX_BODY):
            """Read the request body; an oversized one is drained
            (bounded 1 MB chunks, never buffered, under a short socket
            timeout) so the error response is deliverable — but the
            drain itself is capped at 2x the body limit: a client
            declaring a huge Content-Length and trickling data must not
            occupy a handler thread indefinitely. Whenever the drain
            does NOT consume the declared body (cap exceeded, timeout,
            or early EOF), close_connection is set — leaving unread
            bytes on a kept-alive socket would desync the next request,
            and the possible RST racing the 413 is the lesser evil."""
            length = int(self.headers.get("Content-Length", 0))
            if length > cap:
                left = min(length, 2 * cap)
                old_timeout = self.connection.gettimeout()
                self.connection.settimeout(10.0)
                try:
                    while left > 0:
                        chunk = self.rfile.read(min(left, 1 << 20))
                        if not chunk:
                            break
                        left -= len(chunk)
                except OSError:
                    pass  # slow-trickle client timed out mid-drain
                finally:
                    self.connection.settimeout(old_timeout)
                if length > 2 * cap or left > 0:
                    self.close_connection = True
                raise _BodyTooLarge(
                    f"request body too large ({length} bytes)")
            return self.rfile.read(length)

        def _form(self):
            body = self._read_body()
            ctype = self.headers.get("Content-Type", "")
            if ctype.startswith("multipart/form-data"):
                boundary = ctype.split("boundary=")[1].encode()
                fields = {}
                for part in body.split(b"--" + boundary):
                    if b"Content-Disposition" not in part:
                        continue
                    head, _, content = part.partition(b"\r\n\r\n")
                    content = content.rstrip(b"\r\n-")
                    disp = head.decode(errors="replace")
                    name = disp.split('name="')[1].split('"')[0]
                    fields[name] = content
                return fields
            return {k: v[0].encode() for k, v in
                    urllib.parse.parse_qs(body.decode()).items()}

        def do_GET(self):
            parsed = urllib.parse.urlparse(self.path)
            path = parsed.path
            if path == "/":
                self._send(_PAGE.format(body=self._home()))
            elif path == "/sketcher":
                self._send(_PAGE.format(body=_SKETCHER))
            elif path == "/depict":
                # structure preview (the visual half of the reference's
                # JSME editor page): server-side SVG from our own
                # 2D-layout engine (chem/depict.py)
                q = urllib.parse.parse_qs(parsed.query)
                smiles = q.get("smiles", [""])[0]
                if len(smiles) > 1000:
                    self._send("smiles too long", 400, ctype="text/plain")
                    return
                try:
                    w = int(q.get("w", ["320"])[0])
                    h = int(q.get("h", ["240"])[0])
                except ValueError:
                    self._send("bad w/h", 400, ctype="text/plain")
                    return
                from ..chem.depict import depict_smiles_svg
                svg = depict_smiles_svg(smiles,
                                        width=min(max(w, 32), 1600),
                                        height=min(max(h, 32), 1200))
                if svg is None:
                    self._send("unparseable SMILES", 400, ctype="text/plain")
                else:
                    self._send(svg, ctype="image/svg+xml")
            elif path.startswith("/progress/"):
                ckpt_id = int(path.rsplit("/", 1)[1])
                self._send(json.dumps(state.progress.get(
                    ckpt_id, {"state": "unknown"})), ctype="application/json")
            elif path.startswith("/download_ckpt/"):
                # serve the checkpoint file (reference views.py download)
                ckpt_id = int(path.rsplit("/", 1)[1])
                rows = [c for c in state.db.ckpts() if c["id"] == ckpt_id]
                fp = os.path.join(rows[0]["save_dir"], "best_model.ckpt") \
                    if rows else None
                found = None
                if rows and rows[0]["save_dir"]:
                    for root_, _, files in os.walk(rows[0]["save_dir"]):
                        if "best_model.ckpt" in files:
                            found = os.path.join(root_, "best_model.ckpt")
                            break
                if found:
                    with open(found, "rb") as fh:
                        blob = fh.read()
                    self.send_response(200)
                    self.send_header("Content-Type",
                                     "application/octet-stream")
                    self.send_header("Content-Disposition",
                                     "attachment; filename=model.ckpt")
                    self.send_header("Content-Length", str(len(blob)))
                    self.end_headers()
                    self.wfile.write(blob)
                else:
                    self._send("not found", 404)
            else:
                self._send("not found", 404)

        def do_POST(self):
            path = urllib.parse.urlparse(self.path).path
            try:
                if path == "/upload_data":
                    f = self._form()
                    name = f.get("name", b"dataset").decode()
                    csv_bytes = f.get("file", b"")
                    dpath = os.path.join(state.root, "data",
                                         f"{name}.csv")
                    os.makedirs(os.path.dirname(dpath), exist_ok=True)
                    with open(dpath, "wb") as fh:
                        fh.write(csv_bytes)
                    state.db.add_dataset(name, f.get("class", b"regression")
                                         .decode(), dpath,
                                         user_id=self._current_user())
                    self._redirect()
                elif path == "/train":
                    f = self._form()
                    ckpt_id = state.start_training(
                        int(f["dataset_id"]), f["ckpt_name"].decode(),
                        f.get("dataset_type", b"regression").decode(),
                        int(f.get("epochs", b"10")),
                        int(f.get("ensemble_size", b"1")),
                        user_id=self._current_user())
                    self._send(json.dumps({"ckpt_id": ckpt_id}),
                               ctype="application/json")
                elif path == "/set_user":
                    # switch the active user (reference views.py set_user)
                    f = self._form()
                    uid = int(f.get("user_id", b"1"))
                    self.send_response(303)
                    self.send_header("Location", "/")
                    self.send_header("Set-Cookie",
                                     f"user_id={uid}; Path=/")
                    self.end_headers()
                elif path == "/from_sketch":
                    # the drawing half of the reference's JSME editor
                    # (web/app/templates/ + bundled JSME assets): the
                    # client-side canvas sketcher posts its atom/bond
                    # graph here and the chemistry runtime turns it into
                    # SMILES (validated by a full re-parse)
                    try:
                        payload = json.loads(
                            self._read_body(cap=1_000_000) or b"{}")
                        smi = _sketch_to_smiles(payload)
                        self._send(json.dumps({"smiles": smi}),
                                   ctype="application/json")
                    except Exception as e:
                        self._send(json.dumps({"error": str(e)}), 400,
                                   ctype="application/json")
                elif path == "/validate_smiles":
                    # offline stand-in for the reference's JSME molecule
                    # editor (a bundled third-party JS asset that cannot
                    # be vendored here): server-side structure validation
                    # through the chemistry runtime
                    f = self._form()
                    from ..chem import parse_smiles
                    lines = [s.strip() for s in
                             f.get("smiles", b"").decode().splitlines()
                             if s.strip()]
                    out = [{"smiles": s,
                            "valid": parse_smiles(s.split("|")[0],
                                                  strict=False)
                            is not None} for s in lines]
                    self._send(json.dumps(out), ctype="application/json")
                elif path == "/predict":
                    f = self._form()
                    smiles, preds = state.predict(int(f["ckpt_id"]),
                                                  f["smiles"].decode())
                    import html as _html
                    rows = "".join(
                        f"<tr><td><img src='/depict?smiles="
                        f"{urllib.parse.quote(s)}&w=180&h=130' "
                        f"alt='structure'/></td>"
                        f"<td>{_html.escape(s)}</td>"
                        f"<td>{_html.escape(str(p))}</td></tr>"
                        for s, p in zip(smiles, preds))
                    self._send(_PAGE.format(
                        body=f"<h2>Predictions</h2><table>"
                             f"<tr><th>structure</th><th>smiles</th>"
                             f"<th>prediction</th></tr>"
                             f"{rows}</table><a href='/'>back</a>"))
                elif path == "/create_user":
                    f = self._form()
                    state.db.add_user(f.get("username", b"user").decode())
                    self._redirect()
                elif path == "/upload_checkpoint":
                    # import an externally trained .ckpt
                    # (reference views.py checkpoint upload)
                    f = self._form()
                    name = f.get("name", b"uploaded").decode()
                    blob = f.get("file", b"")
                    cdir = os.path.join(state.root, "ckpts", name)
                    os.makedirs(cdir, exist_ok=True)
                    with open(os.path.join(cdir, "best_model.ckpt"),
                              "wb") as fh:
                        fh.write(blob)
                    cid = state.db.add_ckpt(name, "imported", 0, 1, 0, cdir)
                    state.db.finish_ckpt(cid, {})
                    self._redirect()
                elif path.startswith("/delete_data/"):
                    state.db.delete_dataset(int(path.rsplit("/", 1)[1]))
                    self._redirect()
                elif path.startswith("/delete_ckpt/"):
                    state.db.delete_ckpt(int(path.rsplit("/", 1)[1]))
                    self._redirect()
                else:
                    self._send("not found", 404)
            except _BodyTooLarge as e:
                self._send(_PAGE.format(body=f"<p>error: {e}</p>"), 413)
            except Exception as e:
                traceback.print_exc()
                self._send(_PAGE.format(body=f"<p>error: {e}</p>"), 500)

        def _redirect(self):
            self.send_response(303)
            self.send_header("Location", "/")
            self.end_headers()

        def _home(self) -> str:
            uid = self._current_user()
            users = state.db.users()
            uname = next((u["username"] for u in users if u["id"] == uid),
                         "default")
            user_opts = "".join(
                f"<option value={u['id']}"
                f"{' selected' if u['id'] == uid else ''}>"
                f"{u['username']}</option>" for u in users)
            ds_rows = "".join(
                f"<tr><td>{d['id']}</td><td>{d['dataset_name']}</td>"
                f"<td>{d['class']}</td><td>"
                f"<form method=post action=/delete_data/{d['id']} "
                f"style='margin:0;padding:0;background:none'>"
                f"<button>delete</button></form></td></tr>"
                for d in state.db.datasets(user_id=uid))
            ck_rows = "".join(
                f"<tr><td>{c['id']}</td><td>{c['ckpt_name']}</td>"
                f"<td>{c['class']}</td><td>{'yes' if c['completed'] else 'no'}"
                f"</td><td>{c['stats'] or ''}</td></tr>"
                for c in state.db.ckpts(user_id=uid))
            return f"""
<p>user: <b>{uname}</b>
<form method=post action=/set_user style='display:inline'>
 <select name=user_id>{user_opts}</select><button>switch</button></form>
<form method=post action=/create_user style='display:inline'>
 <input name=username placeholder='new user' size=10>
 <button>create</button></form></p>
<h2>Datasets</h2>
<table><tr><th>id</th><th>name</th><th>type</th><th></th></tr>{ds_rows}</table>
<form method=post action=/upload_data enctype=multipart/form-data>
 <b>Upload dataset</b><br>
 name <input name=name> type <select name=class>
 <option>regression</option><option>classification</option></select>
 <input type=file name=file> <button>upload</button>
</form>
<h2>Checkpoints</h2>
<table><tr><th>id</th><th>name</th><th>type</th><th>done</th><th>stats</th></tr>{ck_rows}</table>
<form method=post action=/train>
 <b>Train</b><br>
 dataset id <input name=dataset_id size=4>
 checkpoint name <input name=ckpt_name>
 type <select name=dataset_type><option>regression</option>
 <option>classification</option></select>
 epochs <input name=epochs value=10 size=4>
 <button>train</button>
</form>
<form method=post action=/predict>
 <b>Predict</b><br>
 checkpoint id <input name=ckpt_id size=4><br>
 <textarea name=smiles rows=4 cols=60 placeholder="one SMILES per line"></textarea><br>
 <button>predict</button>
</form>
<p><a href=/sketcher><b>&#9998; molecule sketcher</b></a> — draw a
structure instead of typing SMILES (the reference bundles the JSME
editor for this; here it is an own canvas editor + the chemistry
runtime's SMILES writer)</p>
<form onsubmit="return false" style='background:#f0f4f8'>
 <b>Structure preview</b> (molecule or polymer ensemble string)<br>
 <input id=prev_smiles size=60
  placeholder='e.g. CC(=O)Oc1ccccc1C(=O)O or [*:1]CC([*:2])C|1.0|&lt;1-2:1.0:1.0'>
 <button onclick="document.getElementById('prev_img').src=
  '/depict?w=340&amp;h=240&amp;smiles='+
  encodeURIComponent(document.getElementById('prev_smiles').value)">
  preview</button><br>
 <img id=prev_img alt=''>
</form>"""

    return Handler


def build_app(root: str, device: str = "cuda") -> tuple:
    """Create (server_factory, state) — reference build_app (web/wsgi.py:9)."""
    state = AppState(root, device)
    return make_handler(state), state


def run_web(host: str = "127.0.0.1", port: int = 5000,
            root: Optional[str] = None, device: str = "cuda") -> None:
    """Serve the GUI (reference web/run.py:23-44)."""
    root = root or os.path.join(os.getcwd(), "web_data")
    handler, _ = build_app(root, device)
    server = ThreadingHTTPServer((host, port), handler)
    print(f"polymer-chemprop-tpu web running on http://{host}:{port}")
    server.serve_forever()


def chemprop_web(argv: Optional[list] = None) -> None:
    import argparse
    p = argparse.ArgumentParser(prog="chemprop_web")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=5000)
    p.add_argument("--root", default=None)
    p.add_argument("--device", default="cuda",
                   help="cuda (the default) or cpu")
    a = p.parse_args(argv)
    run_web(a.host, a.port, a.root, a.device)


def _sketch_to_smiles(payload: dict) -> str:
    """Convert the sketcher's atom/bond graph to SMILES via the chemistry
    runtime (perception + canonical-ish writer), validated by a re-parse."""
    from ..chem import parse_smiles
    from ..chem.mol import Atom, Molecule
    from ..chem.periodic import SYMBOL_TO_NUM
    from ..chem.write import write_smiles

    atoms = payload.get("atoms", [])
    bonds = payload.get("bonds", [])
    if not atoms:
        raise ValueError("empty structure")
    if len(atoms) > 300:
        raise ValueError("structure too large")
    mol = Molecule()
    for a in atoms:
        el = str(a.get("el", "C"))
        if el not in SYMBOL_TO_NUM:
            raise ValueError(f"unknown element {el!r}")
        mol.add_atom(Atom(atomic_num=SYMBOL_TO_NUM[el],
                          formal_charge=int(a.get("charge", 0))))
    for b in bonds:
        i, j = int(b["a"]), int(b["b"])
        order = int(b.get("order", 1))
        if not (0 <= i < len(atoms) and 0 <= j < len(atoms)) or i == j:
            raise ValueError("bad bond endpoints")
        if order not in (1, 2, 3):
            raise ValueError("bond order must be 1-3")
        mol.add_bond(i, j, order)
    mol.perceive(strict=False)
    smi = write_smiles(mol)
    if parse_smiles(smi, strict=False) is None:
        raise ValueError("structure does not round-trip")
    return smi


_SKETCHER = """
<p><a href=/>&larr; back</a></p>
<h2>Molecule sketcher</h2>
<p>Click empty canvas: add atom (bonded to the selected atom).
Click atom: select; click another atom: add/cycle bond (1&rarr;2&rarr;3&rarr;none).
Double-click atom: repaint with the current element. Right-click atom: delete.
Ring buttons arm a template: the next click stamps the ring (on an atom:
attaches it there, like JSME's template toolbar).</p>
<div>
 <span id=palette></span>
 &nbsp; charge <button onclick="chg(1)">+</button>
 <button onclick="chg(-1)">&minus;</button>
 &nbsp; <button id=tpl6 onclick="armRing(6)">&#x2B21; 6-ring</button>
 <button id=tpl5 onclick="armRing(5)">&#x2B20; 5-ring</button>
 <label><input type=checkbox id=arom checked> aromatic</label>
 &nbsp; <button onclick="clearAll()">clear</button>
 <button onclick="toSmiles()"><b>&rarr; SMILES</b></button>
</div>
<canvas id=cv width=640 height=420
 style="border:1px solid #999;background:#fff;margin-top:0.5em"></canvas>
<p><input id=out size=70 readonly placeholder="SMILES appears here">
 <button onclick="preview()">preview</button></p>
<img id=sk_img alt=''>
<script>
const ELS = ["C","N","O","S","P","F","Cl","Br","I"];
let el = "C", atoms = [], bonds = [], sel = -1;
const cv = document.getElementById("cv"), cx = cv.getContext("2d");
const pal = document.getElementById("palette");
ELS.forEach(e => {
  const b = document.createElement("button");
  b.textContent = e; b.id = "el_" + e;
  b.onclick = () => { el = e; paint(); };
  pal.appendChild(b);
});
function hit(x, y) {
  for (let i = 0; i < atoms.length; i++) {
    const dx = atoms[i].x - x, dy = atoms[i].y - y;
    if (dx * dx + dy * dy < 170) return i;
  }
  return -1;
}
function bondBetween(i, j) {
  return bonds.findIndex(b => (b.a === i && b.b === j) ||
                              (b.a === j && b.b === i));
}
let ringN = 0;   // armed ring-template size (0 = off)
function armRing(n) { ringN = (ringN === n) ? 0 : n; paint(); }
function stampRing(n, i, x, y) {
  // aromatic 6-rings stamp kekulized (alternating single/double); the
  // server's perception re-aromatizes them (reference: JSME templates)
  const arom = document.getElementById("arom").checked && n === 6;
  const R = 34, base = atoms.length;
  let cxr = x, cyr = y, start = -Math.PI / 2;
  if (i >= 0) {
    // attach at atom i: ring center sits R beyond i, away from the
    // molecule centroid so the new ring points outward
    let mx = 0, my = 0;
    atoms.forEach(a => { mx += a.x; my += a.y; });
    mx /= atoms.length; my /= atoms.length;
    let dx = atoms[i].x - mx, dy = atoms[i].y - my;
    const L = Math.hypot(dx, dy);
    if (L < 1) { dx = 0; dy = -1; } else { dx /= L; dy /= L; }
    cxr = atoms[i].x + dx * (R + 22); cyr = atoms[i].y + dy * (R + 22);
    start = Math.atan2(atoms[i].y - cyr, atoms[i].x - cxr) + Math.PI / n;
  }
  for (let k = 0; k < n; k++) {
    const th = start + 2 * Math.PI * k / n;
    atoms.push({el: "C", charge: 0,
                x: cxr + R * Math.cos(th), y: cyr + R * Math.sin(th)});
  }
  for (let k = 0; k < n; k++)
    bonds.push({a: base + k, b: base + (k + 1) % n,
                order: arom ? (k % 2 ? 2 : 1) : 1});
  if (i >= 0) bonds.push({a: i, b: base, order: 1});
  sel = -1; ringN = 0;
}
cv.onclick = ev => {
  const r = cv.getBoundingClientRect();
  const x = ev.clientX - r.left, y = ev.clientY - r.top;
  const i = hit(x, y);
  if (ringN) { stampRing(ringN, i, x, y); paint(); return; }
  if (i < 0) {
    atoms.push({el: el, charge: 0, x: x, y: y});
    if (sel >= 0) bonds.push({a: sel, b: atoms.length - 1, order: 1});
    sel = atoms.length - 1;
  } else if (sel < 0 || sel === i) {
    sel = (sel === i) ? -1 : i;
  } else {
    const k = bondBetween(sel, i);
    if (k < 0) bonds.push({a: sel, b: i, order: 1});
    else if (bonds[k].order >= 3) bonds.splice(k, 1);
    else bonds[k].order++;
    sel = i;
  }
  paint();
};
cv.ondblclick = ev => {
  const r = cv.getBoundingClientRect();
  const i = hit(ev.clientX - r.left, ev.clientY - r.top);
  if (i >= 0) { atoms[i].el = el; paint(); }
};
cv.oncontextmenu = ev => {
  ev.preventDefault();
  const r = cv.getBoundingClientRect();
  const i = hit(ev.clientX - r.left, ev.clientY - r.top);
  if (i < 0) return;
  bonds = bonds.filter(b => b.a !== i && b.b !== i)
               .map(b => ({a: b.a - (b.a > i), b: b.b - (b.b > i),
                           order: b.order}));
  atoms.splice(i, 1);
  sel = -1;
  paint();
};
function chg(d) { if (sel >= 0) { atoms[sel].charge += d; paint(); } }
function clearAll() { atoms = []; bonds = []; sel = -1; paint(); }
function paint() {
  cx.clearRect(0, 0, cv.width, cv.height);
  ELS.forEach(e => document.getElementById("el_" + e)
    .style.background = (e === el) ? "#cde" : "");
  document.getElementById("tpl6").style.background =
    (ringN === 6) ? "#cde" : "";
  document.getElementById("tpl5").style.background =
    (ringN === 5) ? "#cde" : "";
  bonds.forEach(b => {
    const p = atoms[b.a], q = atoms[b.b];
    const dx = q.x - p.x, dy = q.y - p.y, L = Math.hypot(dx, dy) || 1;
    const ox = -dy / L * 3, oy = dx / L * 3;
    for (let k = 0; k < b.order; k++) {
      const off = (k - (b.order - 1) / 2) * 2;
      cx.beginPath();
      cx.moveTo(p.x + ox * off, p.y + oy * off);
      cx.lineTo(q.x + ox * off, q.y + oy * off);
      cx.strokeStyle = "#333"; cx.stroke();
    }
  });
  atoms.forEach((a, i) => {
    cx.beginPath();
    cx.arc(a.x, a.y, 11, 0, 7);
    cx.fillStyle = (i === sel) ? "#cde" : "#fff";
    cx.fill(); cx.strokeStyle = (i === sel) ? "#06c" : "#999"; cx.stroke();
    cx.fillStyle = "#000"; cx.textAlign = "center";
    cx.textBaseline = "middle"; cx.font = "13px sans-serif";
    const c = a.charge ? (a.charge > 0 ? "+" : "\\u2212")
                         .repeat(Math.abs(a.charge)) : "";
    cx.fillText(a.el + c, a.x, a.y);
  });
}
async function toSmiles() {
  const resp = await fetch("/from_sketch", {method: "POST",
    headers: {"Content-Type": "application/json"},
    body: JSON.stringify({atoms: atoms.map(a => ({el: a.el,
                                                  charge: a.charge})),
                          bonds: bonds})});
  const d = await resp.json();
  document.getElementById("out").value = d.smiles || ("error: " + d.error);
  if (d.smiles) preview();
}
function preview() {
  const s = document.getElementById("out").value;
  if (s && !s.startsWith("error"))
    document.getElementById("sk_img").src =
      "/depict?w=340&h=240&smiles=" + encodeURIComponent(s);
}
paint();
</script>
"""
