"""The port's serving console against a live threaded server on the CPU.

Every route of ``multimodalspectraltransformer_torch.serve`` is exercised
with a small model (1+1 layers). The evaluate route is held to the JAX
package's evaluate route on the same uploaded records with the same
(converted) parameters: greedy SMILES equal, corr_sampling_prob within 1e-4
relative (float32 logits summed in another order, about 20 tokens). The
AZ-format reader is held to the JAX package's on files the test writes."""

from __future__ import annotations

import json
import os
import sys
import threading
import time
import urllib.error
import urllib.request
from socketserver import ThreadingMixIn
from wsgiref.simple_server import WSGIRequestHandler, WSGIServer, make_server

import jax
import numpy as np
import pytest
import torch

from multimodalspectraltransformer_torch import serve as tserve
from multimodalspectraltransformer_torch.data import pipeline as tdp
from multimodalspectraltransformer_torch.models import convert as tconvert
from multimodalspectraltransformer_torch.models import mmt as tmmt
from multimodalspectraltransformer_torch.serve import jobs as tjobs
from multimodalspectraltransformer_torch.sim import factory as tfactory
from multimodalspectraltransformer_torch.train import checkpoint as tckpt
from multimodalspectraltransformer_torch.utils import config as tconfig
from multimodalspectraltransformer_tpu import serve as jserve
from multimodalspectraltransformer_tpu.data import pipeline as jdp
from multimodalspectraltransformer_tpu.models import mmt as jmmt
from multimodalspectraltransformer_tpu.utils import config as jconfig


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several workers on one host: one intra-op thread each
    keeps the many small CPU ops of the plain kernels from oversubscribing it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TINY = dict(num_encoder_layers=1, num_decoder_layers=1, ffn_dim=64)
SMILES = ["CC(=O)Nc1ccc(O)cc1", "CCOC(=O)c1ccccc1", "OCC(Cl)c1ccncc1"]


class _QuietServer(ThreadingMixIn, WSGIServer):
    daemon_threads = True

    def handle_error(self, request, client_address):  # broken pipes of closed streams
        pass


class _QuietHandler(WSGIRequestHandler):
    def log_message(self, *args):
        pass


class _Live:
    """A threaded server of ``app`` on a free local port."""

    def __init__(self, app):
        self.httpd = make_server("127.0.0.1", 0, app, server_class=_QuietServer,
                                 handler_class=_QuietHandler)
        self.base = f"http://127.0.0.1:{self.httpd.server_address[1]}"
        self.thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self.thread.start()

    def get(self, path: str):
        with urllib.request.urlopen(self.base + path, timeout=60) as r:
            return r.headers.get("Content-Type", ""), r.read()

    def post(self, path: str, payload: dict, status: int = 202) -> dict:
        req = urllib.request.Request(self.base + path, data=json.dumps(payload).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            assert r.status == status, (path, r.status)
            return json.loads(r.read())

    def wait(self, job_id: str, timeout: float = 300.0) -> dict:
        deadline = time.time() + timeout
        while time.time() < deadline:
            d = json.loads(self.get(f"/api/jobs/{job_id}?result=1&log=1")[1])
            if d["status"] not in ("pending", "running"):
                return d
            time.sleep(0.05)
        raise TimeoutError(job_id)

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join(timeout=30)
        assert not self.thread.is_alive()


def _status(live: _Live, path: str) -> int:
    try:
        live.get(path)
    except urllib.error.HTTPError as e:
        return e.code
    return 200


def _port_state(params=None) -> tserve.ServerState:
    st = tserve.ServerState(model_cfg=tconfig.ModelConfig(**TINY), device="cpu")
    if params is not None:
        st.model = tmmt.model_from_state_dict(tconvert.from_jax_params(params), st.model_cfg, "cpu")
    return st


def _records_json(records) -> list[dict]:
    return [{"sample_id": r.sample_id, "smiles": r.smiles, "h1": r.h1, "c13": r.c13,
             "hsqc": r.hsqc, "cosy": r.cosy, "ir": np.asarray(r.ir).tolist()}
            for r in records]


@pytest.fixture(scope="module")
def jax_params():
    return jmmt.init_params(jconfig.ModelConfig(**TINY), jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def records():
    return tfactory.simulate_records(SMILES, sample_ids=[f"m{i}" for i in range(3)],
                                     device="cpu")


@pytest.fixture(scope="module")
def port(jax_params):
    st = _port_state(jax_params)
    live = _Live(tserve.make_app(st))
    yield live, st
    live.close()
    st.jobs.shutdown()


def test_health_index_and_missing_routes(port):
    live, _ = port
    assert json.loads(live.get("/api/health")[1])["ok"]
    ctype, body = live.get("/")
    assert "text/html" in ctype and b"GPU serving console" in body
    assert isinstance(json.loads(live.get("/api/jobs")[1]), list)
    for path in ("/api/nope", "/api/jobs/nonexistent", "/api/jobs/nonexistent/stream",
                 "/api/plot?sample_id=nobody"):
        assert _status(live, path) == 404, path
    req = urllib.request.Request(live.base + "/api/jobs/nonexistent/cancel", data=b"{}")
    with pytest.raises(urllib.error.HTTPError, match="404"):
        urllib.request.urlopen(req, timeout=30)


def test_upload_and_records(port):
    live, _ = port
    out = live.post("/api/upload", {"records": [{
        "sample_id": "u1", "smiles": "CCO", "h1": [[1.2, 3.0], [3.7, 2.0]], "c13": [18.0, 58.0],
        "hsqc": [[1.2, 18.0], [3.7, 58.0]]}]}, status=200)
    assert out["n_uploaded"] == 1
    recs = json.loads(live.get("/api/records?source=uploaded")[1])
    assert {"sample_id": "u1", "smiles": "CCO", "modalities": ["1H", "1H_shape", "13C", "HSQC"]} \
        in recs
    csv_1h = 'sample-id,SMILES,shifts\nc9,CC(=O)C,"[(2.1, 6.0)]"\n'
    assert live.post("/api/upload", {"csv_1h": csv_1h}, status=200)["n_uploaded"] == 1


def test_evaluate_route_matches_jax(port, jax_params, records):
    """The same records uploaded to both servers, the same parameters: each
    molecule's greedy SMILES equal and corr_sampling_prob within 1e-4
    relative; the result has JAX's keys (the port's summary adds
    ``stage_seconds``)."""
    live, _ = port
    jst = jserve.ServerState(model_cfg=jconfig.ModelConfig(**TINY))
    jst.params = jax_params
    jlive = _Live(jserve.make_app(jst))
    try:
        payload = {"records": _records_json(records)}
        request = {"source": "uploaded", "run_mns": False, "max_len": 24}
        out = {}
        for name, srv in (("port", live), ("jax", jlive)):
            srv.post("/api/upload", payload, status=200)
            # the port's server also holds test_upload_and_records' records
            job = srv.post("/api/evaluate", request)
            d = srv.wait(job["job_id"])
            assert d["status"] == "done", d["error"]
            out[name] = d["result"]
    finally:
        jlive.close()
        jst.jobs.shutdown()
    ours = {m["target"]: m for m in out["port"]["molecules"]}
    ref = out["jax"]["molecules"]
    assert len(ref) == len(records) and set(ours) >= {m["target"] for m in ref}
    assert all(m["greedy"] for m in ref)
    for m in ref:
        assert set(ours[m["target"]]) == set(m)
        assert ours[m["target"]]["greedy"] == m["greedy"]
        np.testing.assert_allclose(ours[m["target"]]["corr_sampling_prob"],
                                   m["corr_sampling_prob"], rtol=1e-4, atol=0)
    assert set(out["port"]["summary"]) == set(out["jax"]["summary"]) | {"stage_seconds"}


def test_simulate_stream_plots_and_svgs(port):
    live, st = port
    job = live.post("/api/simulate", {"smiles": ["CC(=O)Nc1ccc(O)cc1", "CCO"],
                                      "sample_ids": ["s0", "s1"]})
    ctype, body = live.get(f"/api/jobs/{job['job_id']}/stream")
    assert "text/event-stream" in ctype
    events = [ln[len("data: "):] for ln in body.decode().splitlines() if ln.startswith("data: ")]
    assert any("simulating" in e for e in events) and events[-1] == "[done]"
    d = live.wait(job["job_id"])
    assert d["status"] == "done" and d["result"]["n_simulated"] == 2
    assert st.sim_records["s0"].ir is not None
    for modality in ("1H", "1H_shape", "13C", "HSQC", "COSY", "IR"):
        ctype, body = live.get(f"/api/plot?source=sim&sample_id=s0&modality={modality}")
        assert "svg" in ctype and body.startswith(b"<svg"), modality
    assert b"polyline" in live.get("/api/plot?source=sim&sample_id=s0&modality=1H_shape")[1]
    live.post("/api/upload", {"records": [{"sample_id": "s0", "smiles": "CC(=O)Nc1ccc(O)cc1",
                                           "hsqc": [[2.0, 25.0], [7.2, 120.0]]}]}, status=200)
    body = live.get("/api/plot?source=sim&sample_id=s0&modality=HSQC&dual=1")[1]
    assert body.startswith(b"<svg") and b"overlay" in body
    assert _status(live, "/api/plot?source=sim&sample_id=s1&modality=nothing") == 404
    body = live.get("/api/molecule.svg?smiles=CC(%3DO)Nc1ccc(O)cc1&values=0.1,0.9,0.5")[1]
    assert body.startswith(b"<svg") and b"circle" in body
    assert live.get("/api/grid.svg?smiles=CCO,c1ccccc1")[1].startswith(b"<svg")
    assert _status(live, "/api/molecule.svg?smiles=bogus((") == 400


def test_evaluate_route_full_pool(port):
    """Sampling, beam hypotheses and simulated errors through the route."""
    live, _ = port
    job = live.post("/api/evaluate", {"source": "sim", "max_len": 24, "fanout": 4,
                                      "multinom_runs": 2, "max_temp_rounds": 1,
                                      "beam_candidates": 2, "simulate_errors": True})
    d = live.wait(job["job_id"])
    assert d["status"] == "done", d["error"]
    assert d["log"][-1] == "evaluation finished"
    mols = d["result"]["molecules"]
    assert len(mols) == 2 and all(isinstance(m["n_candidates"], int) for m in mols)
    assert d["result"]["summary"]["n"] == 2
    assert set(d["result"]["summary"]["top_k_accuracy"]) == {"1", "3", "5", "10", "20"}


def _write_az(out_dir, rows_by_key: dict, ir: dict) -> None:
    """AZ-format files: ``rows_by_key[key]`` is a list of (sample id,
    shifts text, SMILES)."""
    os.makedirs(os.path.join(out_dir, "real_IR"), exist_ok=True)
    for key, rows in rows_by_key.items():
        with open(os.path.join(out_dir, f"real_{key}_with_AZ_SMILES_v3.csv"), "w") as f:
            f.write("sample-id;shifts;SN_Number;AZ_Number;SMILES\n")
            for i, (sid, shifts, smi) in enumerate(rows):
                f.write(f"{sid};{shifts};SN{i};AZ-{i};{smi}\n")
    for sid, values in ir.items():
        with open(os.path.join(out_dir, "real_IR", f"{sid}.csv"), "w") as f:
            f.write("wavelength,spectra\n")
            f.writelines(f"{400 + 2 * i},{v}\n" for i, v in enumerate(values))


def _az_from_records(out_dir, records, smiles_as_written=None) -> None:
    smis = smiles_as_written or [r.smiles for r in records]
    rows = {key: [(r.sample_id, str(getattr(r, attr)), s) for r, s in zip(records, smis)]
            for key, attr in (("1H", "h1"), ("13C", "c13"), ("HSQC", "hsqc"), ("COSY", "cosy"))}
    _write_az(out_dir, rows, {r.sample_id: list(r.ir) for r in records})


def test_load_real_example_matches_jax(tmp_path, records):
    """Stereo markers and explicit [H] in the SMILES, a row whose shifts do
    not parse, a record with no IR file; with and without IR, with a limit."""
    written = ["[H]C(=O)Nc1ccc(O)cc1", "CCOC(=O)c1ccc[C@H]1", "OC[C@@H](Cl)c1ccncc1"]
    _az_from_records(tmp_path, records, written)
    with open(tmp_path / "real_13C_with_AZ_SMILES_v3.csv", "a") as f:
        f.write("m9;[1.0, oops;SN9;AZ-9;CCO\n")
    os.remove(tmp_path / "real_IR" / "m2.csv")
    for kw in ({}, {"use_ir": False}, {"limit": 2}):
        ours = tdp.load_real_example(str(tmp_path), **kw)
        ref = jdp.load_real_example(str(tmp_path), **kw)
        assert len(ours) == len(ref) == kw.get("limit", 3)
        for a, b in zip(ours, ref):
            for key in ("sample_id", "smiles", "h1", "c13", "hsqc", "cosy"):
                assert getattr(a, key) == getattr(b, key), key
            assert (a.ir is None) == (b.ir is None)
            if a.ir is not None:
                np.testing.assert_array_equal(a.ir, b.ir)
    assert "[H]" not in ours[0].smiles and "@" not in "".join(r.smiles for r in ours)


def test_run_exp_data_route(port, records, tmp_path):
    """The experimental-data route on AZ-format files, through the real-data
    blend; the served model's config stays as it was."""
    live, st = port
    _az_from_records(tmp_path, records)
    job = live.post("/api/run_exp_data", {"dir": str(tmp_path), "use_real_data": True,
                                          "max_len": 24, "fanout": 4, "multinom_runs": 2,
                                          "max_temp_rounds": 1})
    d = live.wait(job["job_id"])
    assert d["status"] == "done", d["error"]
    mols = d["result"]["molecules"]
    assert len(mols) == 3 and all("top_ranked" in m and "greedy" in m for m in mols)
    assert st.model.cfg.use_real_data is False
    job = live.post("/api/run_exp_data", {})
    assert live.wait(job["job_id"])["status"] == "failed"


def test_model_route_loads_a_checkpoint_as_a_job(tmp_path):
    st = _port_state()
    live = _Live(tserve.make_app(st))
    try:
        path = str(tmp_path / "tiny.msgpack")
        saved = tmmt.init_model(st.model_cfg, 5, "cpu")
        tckpt.export_params_msgpack(saved, path)
        out = live.post("/api/model", {"checkpoint": path})
        assert out["ok"] and out["layers"] == 1 and out["job"]["kind"] == "load-checkpoint"
        assert live.wait(out["job"]["job_id"])["status"] == "done"
        for k, v in saved.state_dict().items():
            assert torch.equal(st.model.state_dict()[k], v), k
        out = live.post("/api/model", {"preset": "small"}, status=200)
        assert out == {"ok": True, "layers": 2, "loaded": False} and st.model is None
        model, cfg = st.snapshot_model()  # re-initialized lazily for the new shape
        assert cfg == tconfig.ModelConfig.small() and model is st.model
    finally:
        live.close()
        st.jobs.shutdown()


def test_improve_route_installs_a_new_model(jax_params):
    """The improve job fine-tunes and installs a new module; the one a job
    may still hold is left as it was; evaluation then runs on the new one."""
    st = _port_state(jax_params)
    live = _Live(tserve.make_app(st))
    try:
        assert live.wait(live.post("/api/simulate", {"smiles": ["CCOC(=O)c1ccccc1"]})["job_id"]
                         )["status"] == "done"
        old = st.model
        kept = {k: v.clone() for k, v in old.state_dict().items()}
        d = live.wait(live.post("/api/improve", {"max_cycles": 1, "steps_per_cycle": 1})["job_id"])
        assert d["status"] == "done", d["error"]
        (cycle,) = d["result"]["cycles"]
        assert cycle["n_augmented"] > 0 and np.isfinite(cycle["train_loss"])
        assert set(cycle["stage_seconds"]) == {"molgen", "simulate", "train", "evaluate"}
        assert st.model is not old and not st.model.training
        assert all(torch.equal(v, kept[k]) for k, v in old.state_dict().items())
        assert any(not torch.equal(v, kept[k]) for k, v in st.model.state_dict().items())
        d = live.wait(live.post("/api/evaluate", {"source": "sim", "run_mns": False,
                                                  "max_len": 16})["job_id"])
        assert d["status"] == "done" and st.snapshot_model()[0] is st.model
    finally:
        live.close()
        st.jobs.shutdown()


def test_cancel_route_cancels_a_pending_job(port):
    """A job queued behind a running one, cancelled through the route, never
    starts; the job list shows it."""
    live, st = port
    gate = threading.Event()
    st.jobs.submit("gate", lambda job: gate.wait(30))
    try:
        job = live.post("/api/evaluate", {"source": "sim", "run_mns": False})
        out = live.post(f"/api/jobs/{job['job_id']}/cancel", {}, status=200)
        assert out["job_id"] == job["job_id"] and out["status"] == "pending"
    finally:
        gate.set()
    d = live.wait(job["job_id"])
    assert d["status"] == "cancelled" and d["started"] is None
    listed = json.loads(live.get("/api/jobs")[1])
    assert {"job_id": job["job_id"], "status": "cancelled"}.items() <= \
        next(j for j in listed if j["job_id"] == job["job_id"]).items()


def test_json_resp_turns_tensors_and_numpy_into_json():
    got = {}
    body = tserve.app._json_resp(lambda status, headers: got.update(status=status), {
        "t": torch.tensor([[1.5, 2.0]]), "b": np.bool_(True), "i": np.int64(3),
        "f": np.float32(0.5), "a": np.arange(2), "k": {1: 2.0}})
    assert got["status"] == "200 OK"
    assert json.loads(body[0]) == {"t": [[1.5, 2.0]], "b": True, "i": 3, "f": 0.5, "a": [0, 1],
                                   "k": {"1": 2.0}}


def test_job_queue_full_and_cancel_pending_wakeup():
    """Queue refuses submissions once every retained job is unfinished (HTTP
    429 upstream), and cancelling a pending job wakes wait_lines at once."""
    gate = threading.Event()
    q = tjobs.JobQueue(workers=1, max_jobs=3)
    try:
        q.submit("a", lambda job: gate.wait(30))
        pending = q.submit("b", lambda job: "never")
        q.submit("c", lambda job: "done")
        with pytest.raises(tjobs.QueueFullError):
            q.submit("d", lambda job: None)
        t0 = time.time()
        pending.cancel()
        gate.set()
        pending.wait_lines(0, timeout=10.0)
        assert time.time() - t0 < 8.0
        deadline = time.time() + 5.0
        while pending.status != tjobs.CANCELLED and time.time() < deadline:
            time.sleep(0.02)
        assert pending.status == tjobs.CANCELLED and pending.started is None
    finally:
        gate.set()
        q.shutdown()


def test_job_queue_stress_runs_every_job_once():
    """More workers than cores, a short switch interval: every job runs
    exactly once, logs its lines, and ends done."""
    runs: dict[str, int] = {}
    lock = threading.Lock()

    def body(job):
        with lock:
            runs[job.job_id] = runs.get(job.job_id, 0) + 1
        for i in range(5):
            job.log(str(i))
        return job.job_id

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    q = tjobs.JobQueue(workers=2 * (os.cpu_count() or 4), max_jobs=1000)
    try:
        jobs = [q.submit("s", body) for _ in range(300)]
        deadline = time.time() + 60
        while any(j.status != tjobs.DONE for j in jobs) and time.time() < deadline:
            time.sleep(0.02)
    finally:
        sys.setswitchinterval(old)
        q.shutdown()
    assert all(j.status == tjobs.DONE and j.result == j.job_id for j in jobs)
    assert runs == {j.job_id: 1 for j in jobs}
    assert all(j.log_lines()[0] == ["0", "1", "2", "3", "4"] for j in jobs)
