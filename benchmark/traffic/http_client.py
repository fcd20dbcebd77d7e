"""The served cells' clients, in a process of their own (spawned; stdlib
and numpy only, so that they hold no lock the server needs): POST /dress
to the server under test, closed loop (`clients` callers, each sending its
next request when its answer is read).

Protocol over the pipe: the client builds its requests and sends
("ready",); the parent sends ("go", w0, w1) in monotonic seconds; the
client sends ("done", records) once every request sent in the window is
answered or has timed out; the parent sends ("send", [request indices])
and the client answers ("images", {index: PNG bytes})."""

from __future__ import annotations

import base64
import http.client
import json
import threading
import time
from typing import Dict, List

from benchmark.lib import synth


def _post(port: int, body: bytes, timeout: float) -> Dict:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("POST", "/dress", body,
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        data = resp.read()
        return {"status": resp.status, "body": data}
    finally:
        conn.close()


def main(conn, port: int, seed: int, params: Dict) -> None:
    plan = synth.request_plan(seed, params)
    h, w = params["garment_size"]
    pngs = [base64.b64encode(synth.png_encode(
        synth.garment(seed, g, h, w))).decode()
        for g in range(params["n_garments"])]
    n = len(plan["prompt"])

    def body(i: int) -> bytes:
        return json.dumps({"prompt": plan["prompt"][i],
                           "steps": params["steps"],
                           "cloth_image": pngs[plan["garment"][i]]}).encode()

    conn.send(("ready",))
    _, w0, w1 = conn.recv()
    timeout = float(params["request_timeout_s"])
    records: List[Dict] = []
    images: Dict[int, str] = {}
    lock = threading.Lock()

    def send(i: int, due: float) -> None:
        sent = time.monotonic()
        rec = {"index": i, "due": due, "sent": sent, "ok": False}
        try:
            reply = _post(port, body(i), timeout)
            rec["done"] = time.monotonic()
            if reply["status"] == 200:
                answer = json.loads(reply["body"])
                rec.update(ok=True, latency_s=float(answer["latency_s"]))
                with lock:
                    images[i] = answer["image"]
            else:
                rec["error"] = reply["body"][:300].decode(errors="replace")
        except Exception as e:  # noqa: BLE001 - a failed request is counted
            rec["done"] = time.monotonic()
            rec["error"] = f"{type(e).__name__}: {e}"
        with lock:
            records.append(rec)

    counter = iter(range(n))

    def caller() -> None:
        while True:
            now = time.monotonic()
            if now >= w1:
                return
            with lock:
                i = next(counter, None)
            if i is None:
                return
            send(i, max(now, w0))

    while time.monotonic() < w0:
        time.sleep(min(0.01, max(0.0, w0 - time.monotonic())))
    threads = [threading.Thread(target=caller)
               for _ in range(params["clients"])]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    conn.send(("done", sorted(records, key=lambda r: r["index"])))
    _, wanted = conn.recv()
    conn.send(("images", {i: base64.b64decode(images[i]) for i in wanted
                          if i in images}))
    conn.close()
