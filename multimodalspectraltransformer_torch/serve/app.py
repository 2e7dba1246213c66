"""HTTP serving layer (stdlib WSGI).

The port's counterpart of the JAX package's ``serve/app.py``, the functional
equivalent of the reference web app (`MMT_website/Runfolder/app.py`): a
background job queue instead of long-running request handlers, and
Server-Sent Events instead of SocketIO for console streaming. Route map
(reference routes in parentheses):

  GET  /                      minimal single-page UI
  GET  /api/health
  POST /api/model             model preset / checkpoint load job
  POST /api/upload            spectra CSVs / JSON records     (/upload)
  GET  /api/records
  POST /api/simulate          SMILES -> simulated spectra job (/simulate)
  GET  /api/plot              SVG spectra, optional dual overlay
                              (/plot_nmr, /plot_dual_NMR)
  POST /api/evaluate          evaluation-harness job          (/test_model)
  POST /api/run_exp_data      experimental-spectra job        (/run_model_exp_data)
  POST /api/improve           improvement-cycle job           (/run_IC)
  GET  /api/jobs[/<id>]       job status / results
  GET  /api/jobs/<id>/stream  SSE console stream              (SocketIO)
  POST /api/jobs/<id>/cancel
  GET  /api/molecule.svg      per-atom-colored molecule       (/colored_molecule)
  GET  /api/grid.svg          molecule grid

Every piece of device work (model init and checkpoint loads, simulation,
evaluation, fine-tuning) runs on the job queue's one worker thread, so the
GPU is never contended; request threads read host state under the lock.
The state's device is cuda unless the caller asks otherwise.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import threading
import urllib.parse
from typing import Callable, Iterable, Optional

import numpy as np
import torch

from ..data import pipeline as dp
from ..models import mmt
from ..utils.config import DecodeConfig, MMTConfig, ModelConfig, TrainConfig
from ..utils.device import DeviceLike, resolve_device
from . import jobs as jobs_mod
from . import plots, svg

DEFAULT_PORT = 8083  # same port as the reference (`app.py:1275`)


class ServerState:
    """Uploaded/simulated records and the model, guarded by a lock."""

    def __init__(self, model_cfg: Optional[ModelConfig] = None, device: DeviceLike = None):
        self.lock = threading.Lock()
        self.device = resolve_device(device)
        self.records: dict[str, dp.SampleRecord] = {}
        self.sim_records: dict[str, dp.SampleRecord] = {}
        self.model_cfg = model_cfg or ModelConfig()
        self.model: Optional[mmt.MultimodalTransformer] = None
        self.jobs = jobs_mod.JobQueue(workers=1)

    def ensure_model(self, log: Callable[[str], None] = lambda s: None):
        # double-checked locking: the lock is not held through the init, which
        # would freeze every endpoint
        with self.lock:
            if self.model is not None:
                return self.model
            cfg = self.model_cfg
        log("initializing model parameters (untrained)")
        model = mmt.init_model(cfg, seed=0, device=self.device).eval()
        with self.lock:
            if self.model is None and self.model_cfg is cfg:
                self.model = model
            return self.model if self.model is not None else model

    def snapshot_model(self, log: Callable[[str], None] = lambda s: None):
        """(model, its config) as one consistent pair. A job keeps the module
        it was handed: a swap installs a new module and never mutates it."""
        model = self.ensure_model(log)
        with self.lock:
            if self.model is not None:
                model = self.model
        return model, model.cfg

    def load_checkpoint(self, path: str) -> None:
        with self.lock:
            cfg = self.model_cfg
        model = mmt.load_model(path, cfg, device=self.device)
        self.install(model, cfg)

    def install(self, model: mmt.MultimodalTransformer, cfg: ModelConfig) -> None:
        """Make ``model`` (built for ``cfg``) the served model."""
        with self.lock:
            if self.model_cfg is not cfg:
                raise RuntimeError("model preset changed while building the model; retry")
            self.model = model


# ---------------------------------------------------------------------------
# small WSGI toolkit
# ---------------------------------------------------------------------------


class Request:
    def __init__(self, environ):
        self.environ = environ
        self.method = environ["REQUEST_METHOD"]
        self.path = environ.get("PATH_INFO", "/")
        self.query = urllib.parse.parse_qs(environ.get("QUERY_STRING", ""))

    def q(self, name: str, default: str = "") -> str:
        vals = self.query.get(name)
        return vals[0] if vals else default

    def json(self) -> dict:
        try:
            length = int(self.environ.get("CONTENT_LENGTH") or 0)
        except ValueError:
            length = 0
        body = self.environ["wsgi.input"].read(length) if length else b"{}"
        return json.loads(body.decode("utf-8") or "{}")


def _resp(start_response, status: str, body: bytes, ctype: str) -> list[bytes]:
    start_response(status, [
        ("Content-Type", ctype),
        ("Content-Length", str(len(body))),
        ("Access-Control-Allow-Origin", "*"),
    ])
    return [body]


def _json_resp(start_response, obj, status: str = "200 OK") -> list[bytes]:
    def default(o):
        if isinstance(o, torch.Tensor):
            return o.detach().cpu().tolist()
        if isinstance(o, np.bool_):
            return bool(o)
        if isinstance(o, (np.integer,)):
            return int(o)
        if isinstance(o, (np.floating,)):
            return float(o)
        if isinstance(o, np.ndarray):
            return o.tolist()
        if hasattr(o, "__dict__"):
            return {k: v for k, v in o.__dict__.items() if not k.startswith("_")}
        return str(o)

    return _resp(start_response, status, json.dumps(obj, default=default).encode(), "application/json")


# ---------------------------------------------------------------------------


def _record_to_dict(r: dp.SampleRecord) -> dict:
    return {
        "sample_id": r.sample_id,
        "smiles": r.smiles,
        "modalities": [
            m for m, v in (("1H", r.h1), ("1H_shape", r.h1), ("13C", r.c13),
                           ("HSQC", r.hsqc), ("COSY", r.cosy), ("IR", r.ir))
            if v is not None
        ],
    }


def _records_from_payload(payload: dict) -> list[dp.SampleRecord]:
    """Accept JSON records or reference-format CSV text bodies."""
    records: list[dp.SampleRecord] = []
    for rec in payload.get("records", []):
        ir = rec.get("ir")
        records.append(
            dp.SampleRecord(
                sample_id=str(rec.get("sample_id", len(records))),
                smiles=rec.get("smiles", ""),
                h1=rec.get("h1"),
                c13=rec.get("c13"),
                hsqc=rec.get("hsqc"),
                cosy=rec.get("cosy"),
                ir=np.asarray(ir, dtype=np.float32) if ir is not None else None,
            )
        )
    csv_keys = {k: payload[k] for k in ("csv_1h", "csv_13c", "csv_hsqc", "csv_cosy") if payload.get(k)}
    if csv_keys:
        import os
        import tempfile

        with tempfile.TemporaryDirectory() as td:
            paths = {}
            for key, text in csv_keys.items():
                p = os.path.join(td, key + ".csv")
                with open(p, "w") as f:
                    f.write(text)
                paths[key] = p
            records.extend(
                dp.load_spectra_csvs(
                    csv_1h=paths.get("csv_1h", ""),
                    csv_13c=paths.get("csv_13c", ""),
                    csv_hsqc=paths.get("csv_hsqc", ""),
                    csv_cosy=paths.get("csv_cosy", ""),
                )
            )
    return records


_INDEX_HTML = """<!doctype html>
<html><head><meta charset="utf-8"><title>MMT (CUDA) console</title>
<style>
 body{font-family:sans-serif;margin:2rem;max-width:960px}
 textarea{width:100%;height:6rem} pre{background:#f5f5f5;padding:8px;overflow:auto;max-height:18rem}
 button{margin:4px 4px 4px 0;padding:6px 12px} .imgs img,.imgs svg{border:1px solid #ddd;margin:4px}
</style></head><body>
<h2>MultiModalSpectralTransformer — GPU serving console</h2>
<p>SMILES (one per line):</p>
<textarea id="smiles">CC(C)Cc1ccc(C(C)C(=O)O)cc1
CC(=O)Nc1ccc(O)cc1</textarea><br>
<button onclick="simulate()">Simulate spectra</button>
<button onclick="evaluate()">Evaluate model</button>
<button onclick="molecule()">Draw molecules</button>
<h3>Console</h3><pre id="log"></pre>
<h3>Output</h3><div class="imgs" id="out"></div>
<script>
const log = (m)=>{document.getElementById('log').textContent += m + "\\n";};
const smilesList = ()=>document.getElementById('smiles').value.split("\\n").map(s=>s.trim()).filter(Boolean);
async function track(job){
  const es = new EventSource('/api/jobs/'+job.job_id+'/stream');
  es.onmessage = (e)=>{ if(e.data==='[done]'){es.close(); done(job.job_id);} else log(e.data); };
}
async function done(id){
  const r = await (await fetch('/api/jobs/'+id+'?result=1')).json();
  log('job '+id+' -> '+r.status);
  if(r.result) log(JSON.stringify(r.result).slice(0, 2000));
  refreshPlots();
}
async function simulate(){
  const r = await (await fetch('/api/simulate',{method:'POST',headers:{'Content-Type':'application/json'},
    body:JSON.stringify({smiles: smilesList()})})).json();
  log('simulate job '+r.job_id); track(r);
}
async function evaluate(){
  const r = await (await fetch('/api/evaluate',{method:'POST',headers:{'Content-Type':'application/json'},
    body:JSON.stringify({source:'sim'})})).json();
  log('evaluate job '+r.job_id); track(r);
}
async function refreshPlots(){
  const recs = await (await fetch('/api/records?source=sim')).json();
  const out = document.getElementById('out'); out.innerHTML='';
  for(const rec of recs.slice(0,4)){
    for(const m of rec.modalities){
      const img = document.createElement('img');
      img.src = '/api/plot?source=sim&sample_id='+encodeURIComponent(rec.sample_id)+'&modality='+m;
      img.width = 420; out.appendChild(img);
    }
  }
}
function molecule(){
  const out = document.getElementById('out'); out.innerHTML='';
  const img = document.createElement('img');
  img.src='/api/grid.svg?smiles='+encodeURIComponent(smilesList().join(','));
  out.appendChild(img);
}
</script></body></html>"""


def _decode_config(opts: dict) -> DecodeConfig:
    """A request's DecodeConfig: its keys that name DecodeConfig fields."""
    return DecodeConfig(**{k: v for k, v in opts.items() if k in DecodeConfig.__dataclass_fields__})


def make_app(state: Optional[ServerState] = None) -> Callable:
    """Build the WSGI application."""
    st = state or ServerState()

    # -- job bodies ---------------------------------------------------------
    def simulate_job(smiles: list[str], sample_ids: Optional[list[str]]):
        def run(job: jobs_mod.Job):
            from ..sim import factory

            job.log(f"simulating spectra for {len(smiles)} molecules")
            recs = factory.simulate_records(smiles, sample_ids=sample_ids, device=st.device)
            with st.lock:
                for r in recs:
                    st.sim_records[r.sample_id] = r
            job.log(f"simulated {len(recs)} molecules ({len(smiles) - len(recs)} filtered)")
            return {"n_simulated": len(recs), "sample_ids": [r.sample_id for r in recs]}

        return run

    def evaluate_job(source: str, opts: dict):
        def run(job: jobs_mod.Job):
            from ..eval import harness

            with st.lock:
                recs = list((st.sim_records if source == "sim" else st.records).values())
            if not recs:
                raise ValueError(f"no records in source {source!r}; upload or simulate first")
            model, _ = st.snapshot_model(job.log)
            job.log(f"evaluating {len(recs)} molecules (source={source})")
            results, summary = harness.evaluate_molecules(
                recs, model, _decode_config(opts),
                simulate_errors=bool(opts.get("simulate_errors", False)),
                run_mns=bool(opts.get("run_mns", True)),
                device=st.device,
            )
            job.log("evaluation finished")
            return {
                "summary": summary.__dict__,
                "molecules": [
                    {
                        "target": r.target,
                        "greedy": r.greedy,
                        "greedy_exact": r.greedy_exact,
                        "greedy_tanimoto": r.greedy_tanimoto,
                        "corr_sampling_prob": r.corr_sampling_prob,
                        "n_candidates": len(r.candidates),
                        "best_tanimoto": r.best_tanimoto,
                    }
                    for r in results
                ],
            }

        return run

    def exp_data_job(opts: dict):
        """The reference's /run_model_exp_data route (`MMT_website/app.py:
        831`): evaluate the model on REAL experimental spectra (the shipped
        AZ example set or any directory in that format), optionally through
        the ``use_real_data`` blend head (`models_MMT_v15_4.py:965-971`)."""

        def run(job: jobs_mod.Job):
            from ..eval import harness

            dir_path = opts.get("dir", "")
            if not dir_path:
                raise ValueError("exp_data: pass {'dir': <real-example directory>}")
            recs = dp.load_real_example(dir_path, use_ir=bool(opts.get("use_ir", True)))
            if not recs:
                raise ValueError(f"no real-example records in {dir_path!r}")
            model, model_cfg = st.snapshot_model(job.log)
            if bool(opts.get("use_real_data", False)):
                # a shallow copy shares the served model's parameters; only
                # its config differs, and the served module stays as it was
                model = copy.copy(model)
                model.cfg = dataclasses.replace(model_cfg, use_real_data=True)
            job.log(f"evaluating {len(recs)} experimental molecules from {dir_path}")
            results, summary = harness.evaluate_molecules(
                recs, model, _decode_config(opts),
                simulate_errors=bool(opts.get("simulate_errors", True)),
                device=st.device,
            )
            job.log("experimental-data evaluation finished")
            out_mols = []
            for r in results:
                ranked = harness.rank_candidates_by_error(r)
                out_mols.append({
                    "target": r.target,
                    "greedy": r.greedy,
                    "greedy_exact": r.greedy_exact,
                    "greedy_tanimoto": r.greedy_tanimoto,
                    "corr_sampling_prob": r.corr_sampling_prob,
                    "n_candidates": len(r.candidates),
                    "best_tanimoto": r.best_tanimoto,
                    "top_ranked": [
                        {"smiles": c.smiles, "tanimoto": c.tanimoto,
                         "exact": c.exact, "hsqc_error": c.hsqc_error,
                         "cosy_error": c.cosy_error}
                        for c in ranked[:5]
                    ],
                })
            return {"summary": summary.__dict__, "molecules": out_mols}

        return run

    def improve_job(opts: dict):
        def run(job: jobs_mod.Job):
            from ..train import improvement_cycle as ic

            with st.lock:
                recs = list(st.sim_records.values()) or list(st.records.values())
            if not recs:
                raise ValueError("no records; simulate or upload first")
            model, model_cfg = st.snapshot_model(job.log)
            cfg = MMTConfig(model=model_cfg, train=TrainConfig())
            icfg = ic.ImprovementCycleConfig(
                max_cycles=int(opts.get("max_cycles", 1)),
                ic_threshold=float(opts.get("ic_threshold", 0.6)),
                steps_per_cycle=int(opts.get("steps_per_cycle", 5)),
            )
            job.log(f"improvement cycle over {len(recs)} targets, max_cycles={icfg.max_cycles}")
            new_params, reports = ic.run_improvement_cycle(
                cfg, recs, model.state_dict(), icfg, seed=0,
                should_stop=lambda: job.cancelled,  # cancel between cycles
                device=st.device,
            )
            # a new module: a queued job may still hold the old one
            st.install(mmt.model_from_state_dict(new_params, model_cfg, st.device), model_cfg)
            job.log("improvement cycle finished")
            return {
                "cycles": [
                    {"cycle": r.cycle, "n_augmented": r.n_augmented, "train_loss": r.train_loss,
                     "stage_seconds": r.stage_seconds}
                    for r in reports
                ]
            }

        return run

    # -- request handling ---------------------------------------------------
    def app(environ, start_response) -> Iterable[bytes]:
        req = Request(environ)
        path, method = req.path, req.method
        try:
            if path == "/" and method == "GET":
                return _resp(start_response, "200 OK", _INDEX_HTML.encode(), "text/html; charset=utf-8")

            if path == "/api/health":
                return _json_resp(start_response, {"ok": True, "records": len(st.records), "sim_records": len(st.sim_records)})

            if path == "/api/model" and method == "POST":
                payload = req.json()
                if payload.get("preset"):
                    small = payload["preset"] == "small"
                    with st.lock:
                        st.model_cfg = (
                            ModelConfig.small()
                            if small else ModelConfig()
                        )
                        st.model = None  # re-init lazily for the new shape
                if payload.get("checkpoint"):
                    # device work (the load) goes through the job queue: the
                    # request thread never touches the device alongside a
                    # running job
                    ckpt_path = payload["checkpoint"]

                    def load_job(job):
                        job.log(f"loading checkpoint {ckpt_path}")
                        st.load_checkpoint(ckpt_path)
                        return {"loaded": ckpt_path}

                    try:
                        job = st.jobs.submit("load-checkpoint", load_job)
                    except jobs_mod.QueueFullError as e:
                        return _json_resp(start_response, {"error": str(e)}, "429 Too Many Requests")
                    return _json_resp(start_response, {
                        "ok": True,
                        "layers": st.model_cfg.num_encoder_layers,
                        "job": job.to_dict(),
                    }, "202 Accepted")
                return _json_resp(start_response, {
                    "ok": True,
                    "layers": st.model_cfg.num_encoder_layers,
                    "loaded": False,
                })

            if path == "/api/upload" and method == "POST":
                recs = _records_from_payload(req.json())
                with st.lock:
                    for r in recs:
                        st.records[r.sample_id] = r
                return _json_resp(start_response, {"n_uploaded": len(recs)})

            if path == "/api/records":
                source = req.q("source", "uploaded")
                with st.lock:
                    store = st.sim_records if source == "sim" else st.records
                    return _json_resp(start_response, [_record_to_dict(r) for r in store.values()])

            if path == "/api/simulate" and method == "POST":
                payload = req.json()
                smiles = payload.get("smiles", [])
                try:
                    job = st.jobs.submit("simulate", simulate_job(smiles, payload.get("sample_ids")))
                except jobs_mod.QueueFullError as e:
                    return _json_resp(start_response, {"error": str(e)}, "429 Too Many Requests")
                return _json_resp(start_response, job.to_dict(), "202 Accepted")

            if path == "/api/evaluate" and method == "POST":
                payload = req.json()
                try:
                    job = st.jobs.submit("evaluate", evaluate_job(payload.get("source", "sim"), payload))
                except jobs_mod.QueueFullError as e:
                    return _json_resp(start_response, {"error": str(e)}, "429 Too Many Requests")
                return _json_resp(start_response, job.to_dict(), "202 Accepted")

            if path == "/api/run_exp_data" and method == "POST":
                payload = req.json()
                job = st.jobs.submit("exp_data", exp_data_job(payload))
                return _json_resp(start_response, job.to_dict(), "202 Accepted")

            if path == "/api/improve" and method == "POST":
                try:
                    job = st.jobs.submit("improve", improve_job(req.json()))
                except jobs_mod.QueueFullError as e:
                    return _json_resp(start_response, {"error": str(e)}, "429 Too Many Requests")
                return _json_resp(start_response, job.to_dict(), "202 Accepted")

            if path == "/api/jobs" and method == "GET":
                return _json_resp(start_response, st.jobs.list_jobs())

            if path.startswith("/api/jobs/"):
                rest = path[len("/api/jobs/"):]
                if rest.endswith("/stream"):
                    job = st.jobs.get(rest[: -len("/stream")])
                    if job is None:
                        return _json_resp(start_response, {"error": "no such job"}, "404 Not Found")
                    start_response("200 OK", [
                        ("Content-Type", "text/event-stream"),
                        ("Cache-Control", "no-cache"),
                        ("Access-Control-Allow-Origin", "*"),
                    ])

                    def sse():
                        cursor = 0
                        while True:
                            lines, cursor, finished = job.wait_lines(cursor, timeout=15.0)
                            if not lines and not finished:
                                # keepalive comment: makes the write fail
                                # fast on a dead socket so a disconnected
                                # client's thread is reclaimed instead of
                                # pinning the server until the job ends
                                yield b": keepalive\n\n"
                                continue
                            for ln in lines:
                                yield f"data: {ln}\n\n".encode()
                            if finished:
                                yield b"data: [done]\n\n"
                                return

                    return sse()
                if rest.endswith("/cancel") and method == "POST":
                    job = st.jobs.get(rest[: -len("/cancel")])
                    if job is None:
                        return _json_resp(start_response, {"error": "no such job"}, "404 Not Found")
                    job.cancel()
                    return _json_resp(start_response, job.to_dict())
                job = st.jobs.get(rest)
                if job is None:
                    return _json_resp(start_response, {"error": "no such job"}, "404 Not Found")
                include_result = req.q("result") == "1"
                d = job.to_dict(include_result=include_result)
                if req.q("log") == "1":
                    d["log"], _ = job.log_lines()
                return _json_resp(start_response, d)

            if path == "/api/plot":
                sid = req.q("sample_id")
                modality = req.q("modality", "1H")
                source = req.q("source", "uploaded")
                with st.lock:
                    store = st.sim_records if source == "sim" else st.records
                    rec = store.get(sid)
                    overlay = None
                    if req.q("dual") == "1":
                        other = st.records if source == "sim" else st.sim_records
                        overlay = other.get(sid)
                if rec is None:
                    return _json_resp(start_response, {"error": "no such sample"}, "404 Not Found")
                out = plots.plot_record(rec, modality, overlay)
                if out is None:
                    return _json_resp(start_response, {"error": f"no {modality} data"}, "404 Not Found")
                return _resp(start_response, "200 OK", out.encode(), "image/svg+xml")

            if path == "/api/molecule.svg":
                smiles = req.q("smiles")
                values = None
                if req.q("values"):
                    values = [float(v) for v in req.q("values").split(",")]
                out = svg.mol_to_svg(smiles, atom_values=values, title=req.q("title", ""))
                if out is None:
                    return _json_resp(start_response, {"error": "invalid SMILES"}, "400 Bad Request")
                return _resp(start_response, "200 OK", out.encode(), "image/svg+xml")

            if path == "/api/grid.svg":
                smiles = [s for s in req.q("smiles").split(",") if s]
                out = svg.grid_svg(smiles)
                return _resp(start_response, "200 OK", out.encode(), "image/svg+xml")

            return _json_resp(start_response, {"error": "not found"}, "404 Not Found")
        except Exception as exc:  # surfacing handler bugs as 500 JSON
            return _json_resp(start_response, {"error": str(exc)}, "500 Internal Server Error")

    app.state = st  # type: ignore[attr-defined]
    return app


def serve(port: int = DEFAULT_PORT, state: Optional[ServerState] = None):
    """Run a threading WSGI server (blocking)."""
    from socketserver import ThreadingMixIn
    from wsgiref.simple_server import WSGIServer, make_server

    class ThreadingWSGIServer(ThreadingMixIn, WSGIServer):
        daemon_threads = True

    app = make_app(state)
    httpd = make_server("0.0.0.0", port, app, server_class=ThreadingWSGIServer)
    print(f"MMT serving on http://0.0.0.0:{port}")
    httpd.serve_forever()
