"""Served traffic: the program's HTTP app (`apps.serve.make_handler` over
`InferenceWorker`, in a `ThreadingHTTPServer` in this process), its
pipeline wrapped by the benchmark's `RecordingPipe`, and the clients of
`http_client` in a spawned process, closed loop. After the window, a sample of the answered requests
drawn from the seed is handed to the check, each with the call row that
served it."""

from __future__ import annotations

import multiprocessing
import threading
from http.server import ThreadingHTTPServer
from typing import Dict, List

from benchmark.lib import synth
from benchmark.lib.recorder import row_digest
from benchmark.reference.pipeline import (
    DEFAULT_NEGATIVE,
    HashTokenizer,
    prepare_garment,
)
from benchmark.traffic import http_client


def warm_batches(params: Dict) -> List[int]:
    """Every batch the worker can form."""
    return list(range(1, params["max_batch"] + 1))


def drive(run) -> None:
    from imagdressing_tpu_torch.apps.serve import InferenceWorker, make_handler
    from imagdressing_tpu_torch.apps.tokenizer import load_tokenizer

    p = run.params
    tokenizer = load_tokenizer("")
    if run.tiny:
        tokenizer = type(tokenizer)(run.config["text"]["vocab_size"])
    worker = InferenceWorker(run.pipe, tokenizer, max_batch=p["max_batch"])
    httpd = ThreadingHTTPServer(("127.0.0.1", 0),
                                make_handler(worker, run.pipe.pipe.preset))
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    ctx = multiprocessing.get_context("spawn")
    conn, child_conn = ctx.Pipe()
    client = ctx.Process(target=http_client.main,
                         args=(child_conn, httpd.server_address[1], run.seed,
                               p))
    client.start()
    try:
        if not conn.poll(120):
            raise RuntimeError("the client process did not get ready")
        conn.recv()
        w0, w1 = run.begin_window()
        conn.send(("go", w0, w1))
        if not conn.poll(run.seconds + p["request_timeout_s"] + 60):
            raise RuntimeError("the clients did not finish")
        _, records = conn.recv()
        run.end_window()
        run.requests = records
        answered = sorted(r["index"] for r in records if r["ok"])
        rng = synth.rng_for(run.seed, 7)
        k = min(run.check["samples"], len(answered))
        wanted = sorted(int(i) for i in rng.choice(answered, k,
                                                   replace=False)) if k else []
        conn.send(("send", wanted))
        _, images = conn.recv()
    finally:
        client.join(60)
        if client.is_alive():
            client.kill()
            client.join()
        httpd.shutdown()
        httpd.server_close()
        server.join(10)
        worker.pipe = None  # the idle worker thread keeps no program state
    run.samples = _samples(run, records, wanted, images)


def _samples(run, records, wanted, images) -> List[Dict]:
    """Each sampled request with its inputs as the reference rebuilds them
    and the served image; the call row is found by the request's prompt,
    which no other request shares."""
    p, cfg = run.params, run.config
    plan = synth.request_plan(run.seed, p)
    tok = HashTokenizer(cfg["text"]["vocab_size"])
    rows = {}
    for n, call in enumerate(run.calls_all):
        for r, digest in enumerate(call["rows"]):
            rows[digest] = (n, r)
    out = []
    for i in wanted:
        g = plan["garment"][i]
        h, w = p["garment_size"]
        ids = tok(plan["prompt"][i])
        where = rows.get(row_digest(ids))
        call = run.calls_all[where[0]] if where else None
        out.append(dict(
            name=f"request {i}", served_png=images.get(i),
            call=call, row=None if where is None else where[1],
            prompt_ids=ids, negative_ids=tok(DEFAULT_NEGATIVE),
            steps=p["steps"], pose=None,
            garment=lambda g=g, h=h, w=w: prepare_garment(
                synth.garment(run.seed, g, h, w), cfg["height"],
                cfg["width"], cfg["vision"]["image_size"], "bicubic")))
    return out
