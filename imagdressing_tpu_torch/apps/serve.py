"""Serving app (port of `imagdressing_tpu/apps/serve.py`).

  * the models load once, onto the card (`--device cuda`, the default);
  * requests flow through a queue into a single device worker that
    micro-batches compatible requests (the same per-call settings) up to
    `max_batch`;
  * a stdlib ThreadingHTTPServer exposes POST /dress (JSON), POST
    /dress_form (multipart) and a minimal HTML form at / (gradio is used
    instead when installed: `--ui gradio`).

API:
  POST /dress  {"prompt": str, "negative_prompt": str, "steps": int,
                "guidance_scale": float, "image_scale": float, "seed": int,
                "cloth_image": base64 image (PNG; JPEG where PIL is installed),
                "fusion_face": optional base64 face photo, fused into the
                result under `--post_process face_fusion:<facenet.pth>`}
  -> {"image": base64-png, "latency_s": float}

Run: python -m imagdressing_tpu_torch.apps.serve --base_dir ... (see
`main`); `--device cpu` runs every kernel's plain version on the host.

Over several GPUs (`--data_parallel N`, -1 every visible GPU, and
`--tensor_parallel M`, as `apps.dress`; or one rank of a torchrun world)
rank 0 runs the HTTP server and the micro-batching worker; each round's
arguments go to every rank over a gloo control group (`MeshPipe`), and
every rank runs the call (`follow`): the batch's rows split over the data
ranks, the UNets over the model ranks. An idle server sends a heartbeat so
that the other ranks' wait stays within the group's timeout. Asking for
more GPUs than are visible raises.

Spans (`core.profiling`, while a profiler session runs), all of one
request under its trace_id: `serve.decode` (the body's base64 and image
decode, the garment's preparation), `serve.queue` (from the queue's put
to the start of the round that takes it), `serve.round` (batch; the
trace_id of its first request, `trace_ids` all of them; the pipeline's
`pipeline.call` inside) and `serve.encode` (the result's PNG and base64).
"""

from __future__ import annotations

import base64
import json
import queue
import threading
import time
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from imagdressing_tpu_torch.apps import image_utils as iu
from imagdressing_tpu_torch.apps.png import encode_png
from imagdressing_tpu_torch.core import profiling
from imagdressing_tpu_torch.train.data import clip_preprocess_np

# seconds between the idle server's heartbeats to the other ranks
HEARTBEAT_S = 60.0

_FORM = """<!doctype html><title>IMAGDressing</title>
<h2>IMAGDressing</h2>
<form method=post action=/dress_form enctype=multipart/form-data>
Garment image: <input type=file name=cloth><br>
Prompt: <input name=prompt size=60 value="A beautiful woman, best quality"><br>
Steps: <input name=steps value=30 size=4>
Guidance: <input name=guidance_scale value=7.5 size=4>
Cloth scale: <input name=image_scale value=1.0 size=4>
Seed: <input name=seed value=42 size=8><br>
<input type=submit value=Dress>
</form>"""


@dataclass
class _Request:
    payload: Dict[str, Any]
    trace_id: int
    t_put: float  # monotonic, when it was queued
    event: threading.Event = field(default_factory=threading.Event)
    result: Optional[Dict[str, Any]] = None


class InferenceWorker:
    """Single device-owner thread; micro-batches queued requests.

    `post_process(img01, payload) -> img01` runs on every decoded image:
    the seam for the reference's face-fusion step. The hook always sees
    float32 [0, 1] (the worker converts around the uint8 device transport);
    the worker's `result["image"]` is uint8 HxWx3 in [0, 255].
    """

    def __init__(self, pipe, tokenizer, *, max_batch: int = 4,
                 post_process=None):
        self.pipe = pipe
        self.tokenizer = tokenizer
        self.max_batch = max_batch
        self.post_process = post_process
        self.queue: "queue.Queue[_Request]" = queue.Queue()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def submit(self, payload: Dict[str, Any],
               trace_id: Optional[int] = None) -> Dict[str, Any]:
        """Queue one request and wait for its result; `trace_id`: its
        spans' (a new one where None)."""
        req = _Request(payload, profiling.next_trace_id()
                       if trace_id is None else trace_id, time.monotonic())
        self.queue.put(req)
        req.event.wait()
        assert req.result is not None
        return req.result

    def _collect(self) -> List[_Request]:
        batch = [self.queue.get()]
        key = self._batch_key(batch[0])
        while len(batch) < self.max_batch:
            try:
                nxt = self.queue.get_nowait()
            except queue.Empty:
                break
            if self._batch_key(nxt) == key:
                batch.append(nxt)
            else:
                # different config: run it in its own round
                self.queue.put(nxt)
                break
        return batch

    @staticmethod
    def _batch_key(req: _Request):
        # every per-CALL (not per-sample) pipeline argument must be in the
        # key: requests only share a batch when the whole call config
        # matches, otherwise later requests would silently inherit the
        # first request's seed / scales
        p = req.payload
        return (p.get("steps"), p.get("guidance_scale"),
                p.get("seed", 42), p.get("image_scale"))

    def _loop(self):
        while True:
            batch = self._collect()
            t_round = time.monotonic()
            for r in batch:
                profiling.record("serve.queue", r.t_put, t_round,
                                 trace_id=r.trace_id)
            t0 = time.perf_counter()
            try:
                with profiling.span("serve.round",
                                    trace_id=batch[0].trace_id,
                                    batch=len(batch),
                                    trace_ids=[r.trace_id for r in batch]):
                    self._round(batch, t0)
            except Exception as e:  # noqa: BLE001 - report errors per request
                for r in batch:
                    if r.event.is_set():
                        continue  # already answered (a post_process failed
                        # on a LATER batch member): don't clobber
                    r.result = {"error": f"{type(e).__name__}: {e}"}
                    r.event.set()

    def _round(self, batch: List[_Request], t0: float) -> None:
        """One pipeline call for the batch; each request answered."""
        prompts = np.stack(
            [self.tokenizer(r.payload["prompt"]) for r in batch])
        negatives = np.stack([
            self.tokenizer(r.payload.get("negative_prompt",
                                         iu.DEFAULT_NEGATIVE))
            for r in batch])
        refs = np.concatenate([r.payload["ref_image"] for r in batch])
        clips = np.concatenate([r.payload["ref_clip_image"] for r in batch])
        first = batch[0].payload
        out = self.pipe(
            prompt_ids=prompts,
            negative_prompt_ids=negatives,
            ref_image=refs,
            ref_clip_image=clips,
            seed=int(first.get("seed", 42)),
            num_inference_steps=int(first.get("steps") or 0) or None,
            guidance_scale=first.get("guidance_scale"),
            image_scale=first.get("image_scale"),
            # the serving contract: uint8 readback, a quarter of the float
            # bytes; _png_b64 consumes it as-is
            output_uint8=True,
        )
        dt = time.perf_counter() - t0
        for i, r in enumerate(batch):
            img = out[i]
            if self.post_process is not None:
                img01 = self.post_process(
                    img.astype(np.float32) / 255.0, r.payload)
                img = np.clip(np.asarray(img01, np.float32) * 255.0,
                              0, 255).round().astype(np.uint8)
            r.result = {"image": img, "latency_s": dt}
            r.event.set()


class MeshPipe:
    """Rank 0's pipeline over a mesh: a call's arguments go to every rank
    first (over `group`, a gloo process group of all ranks), then rank 0
    runs its part of the call, which the other ranks run in `follow`.
    While no call comes, a heartbeat goes out every `heartbeat_s`."""

    def __init__(self, pipe, group, heartbeat_s: float = HEARTBEAT_S):
        self.pipe, self.group = pipe, group
        self.models = pipe.models
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._beat = threading.Thread(target=self._heartbeat,
                                      args=(heartbeat_s,), daemon=True)
        self._beat.start()

    def _send(self, message) -> None:
        from imagdressing_tpu_torch.core.mesh import broadcast_object

        broadcast_object(message, self.group)

    def _heartbeat(self, every: float) -> None:
        while not self._stop.wait(every):
            with self._lock:
                self._send(("beat", None))

    def __call__(self, **kwargs):
        with self._lock:
            self._send(("call", kwargs))
            return self.pipe(**kwargs)

    def close(self) -> None:
        """Release the other ranks from `follow`."""
        self._stop.set()
        self._beat.join()
        with self._lock:
            self._send(("stop", None))


def follow(pipe, group) -> None:
    """A rank other than 0: run every call `MeshPipe` announces, until it
    closes."""
    from imagdressing_tpu_torch.core.mesh import broadcast_object

    while True:
        op, kwargs = broadcast_object(None, group)
        if op == "stop":
            return
        if op == "call":
            pipe(**kwargs)


def _png_b64(img: np.ndarray) -> str:
    if img.dtype != np.uint8:
        img = (np.clip(img, 0, 1) * 255).astype(np.uint8)
    return base64.b64encode(encode_png(img)).decode()


def garment_inputs(cloth: np.ndarray, preset, clip_size: int
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """An uploaded garment, uint8 RGB -> (ref_image (1, H, W, 3) in [-1, 1],
    ref_clip_image (1, clip_size, clip_size, 3)): the reference app's
    preparation (the snap-to-64 resize, then a bicubic resize to the
    preset's size, PIL's default there, and the CLIP view)."""
    cloth = iu.resize_img(cloth)
    ref = iu.resize(cloth, (preset.width, preset.height), "bicubic")
    ref = (ref.astype(np.float32) / 127.5 - 1.0)[None]
    return ref, clip_preprocess_np(cloth, size=clip_size)[None]


def make_handler(worker: InferenceWorker, preset):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet
            pass

        def _send(self, code: int, body: bytes, ctype: str):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            self._send(200, _FORM.encode(), "text/html")

        def do_POST(self):
            length = int(self.headers.get("Content-Length", "0"))
            raw = self.rfile.read(length)
            trace_id = profiling.next_trace_id()
            try:
                with profiling.span("serve.decode", trace_id=trace_id):
                    if self.path == "/dress":
                        payload = json.loads(raw)
                        cloth = iu.read_image(
                            base64.b64decode(payload.pop("cloth_image")))
                    elif self.path == "/dress_form":
                        payload, cloth = _parse_multipart(
                            raw, self.headers.get("Content-Type", ""))
                    else:
                        self._send(404, b"not found", "text/plain")
                        return
                    payload["ref_image"], payload["ref_clip_image"] = \
                        garment_inputs(
                            cloth, preset,
                            worker.pipe.models.vision_cfg.image_size)
                payload.setdefault("prompt", iu.DEFAULT_PROMPT)
                result = worker.submit(payload, trace_id)
                if "error" in result:
                    self._send(500, json.dumps(result).encode(),
                               "application/json")
                    return
                with profiling.span("serve.encode", trace_id=trace_id):
                    b64 = _png_b64(result["image"])
                if self.path == "/dress_form":
                    html = (f"<img src='data:image/png;base64,{b64}'>"
                            f"<p>{result['latency_s']:.2f}s</p>")
                    self._send(200, html.encode(), "text/html")
                else:
                    self._send(200, json.dumps(
                        {"image": b64, "latency_s": result["latency_s"]}
                    ).encode(), "application/json")
            except Exception as e:  # noqa: BLE001 - a bad request, answered
                self._send(400, json.dumps(
                    {"error": f"{type(e).__name__}: {e}"}).encode(),
                    "application/json")

    return Handler


def _parse_multipart(raw: bytes, content_type: str):
    import email
    import email.policy

    msg = email.message_from_bytes(
        b"Content-Type: " + content_type.encode() + b"\r\n\r\n" + raw,
        policy=email.policy.HTTP,
    )
    payload: Dict[str, Any] = {}
    cloth = None
    for part in msg.iter_parts():
        name = part.get_param("name", header="content-disposition")
        data = part.get_payload(decode=True)
        if name == "cloth":
            cloth = iu.read_image(data)
        elif name in ("steps", "seed"):
            payload[name] = int(data.decode() or 0)
        elif name in ("guidance_scale", "image_scale"):
            payload[name] = float(data.decode() or 0)
        elif name:
            payload[name] = data.decode()
    if cloth is None:
        raise ValueError("no cloth image uploaded")
    return payload, cloth


def load_post_process(spec: str, device="cuda"):
    """Resolve a post-process spec to a `(img01, payload) -> img01` callable.

    Accepted forms:
      * ``module:function``: any importable callable;
      * ``face_fusion:<facenet.pth>``: the built-in face fusion
        (`postprocess/face_fusion.py`) with the OpenPose FaceNet at that
        path, on `device`; a request carrying a ``fusion_face`` image
        (base64 in the JSON API) gets the user's face fused into the
        result, the reference's image_face_fusion step.
    """
    import importlib

    head, _, rest = spec.partition(":")
    if head == "face_fusion":
        if not rest:
            raise ValueError(
                "--post_process face_fusion needs the FaceNet weight path: "
                "face_fusion:<body_pose-style facenet .pth>")
        from imagdressing_tpu_torch.postprocess.face_fusion import (
            make_post_process,
            openpose_landmark_fn,
        )
        from imagdressing_tpu_torch.preprocess.openpose.face import Face

        return make_post_process(openpose_landmark_fn(
            Face.from_torch(rest, device)))
    if not rest:
        raise ValueError(
            f"--post_process expects 'module:function', got {spec!r}")
    return getattr(importlib.import_module(head), rest)


def run_gradio(worker: InferenceWorker, preset, port: int):
    """Gradio UI over the same worker (the reference app's surface).

    gradio is an optional dependency; the stdlib HTTP UI (`--ui http`) is the
    default and needs nothing.
    """
    try:
        import gradio as gr
    except ImportError as e:
        raise RuntimeError(
            "--ui gradio requires the 'gradio' package (pip install gradio); "
            "use --ui http for the dependency-free built-in UI"
        ) from e

    def dress(cloth, prompt, steps, guidance_scale, image_scale, seed):
        ref, clip = garment_inputs(iu.to_rgb(np.asarray(cloth, np.uint8)),
                                   preset,
                                   worker.pipe.models.vision_cfg.image_size)
        result = worker.submit({
            "prompt": prompt or iu.DEFAULT_PROMPT,
            "steps": int(steps),
            "guidance_scale": float(guidance_scale),
            "image_scale": float(image_scale),
            "seed": int(seed),
            "ref_image": ref,
            "ref_clip_image": clip,
        })
        if "error" in result:
            raise RuntimeError(result["error"])
        return result["image"]  # uint8 HxWx3 (the worker's contract)

    demo = gr.Interface(
        fn=dress,
        inputs=[
            gr.Image(type="numpy", label="Garment"),
            gr.Textbox(value=iu.DEFAULT_PROMPT, label="Prompt"),
            gr.Slider(1, 100, value=30, step=1, label="Steps"),
            gr.Slider(1.0, 15.0, value=7.5, label="Guidance"),
            gr.Slider(0.0, 2.0, value=1.0, label="Cloth scale"),
            gr.Number(value=42, label="Seed"),
        ],
        outputs=gr.Image(label="Result"),
        title="IMAGDressing",
    )
    demo.launch(server_name="0.0.0.0", server_port=port)


def build_argparser():
    import argparse

    p = argparse.ArgumentParser(description="IMAGDressing server (PyTorch)")
    p.add_argument("--server_port", type=int, default=7860)
    p.add_argument("--ui", default="http", choices=["http", "gradio"],
                   help="'http' = dependency-free built-in form; 'gradio' "
                        "needs the optional gradio package")
    p.add_argument("--post_process", default=None,
                   help="'module:function' applied to each decoded image, "
                        "or 'face_fusion:<facenet.pth>' (the built-in face "
                        "fusion of a request's fusion_face)")
    p.add_argument("--preset", default="basic")
    p.add_argument("--model_ckpt", default="ckpt/IMAGDressing-v1_512.pt")
    p.add_argument("--base_dir", default="ckpt/Realistic_Vision_V4.0_noVAE")
    p.add_argument("--vae_path", default="ckpt/sd-vae-ft-mse")
    p.add_argument("--image_encoder_path", default="ckpt/image_encoder")
    p.add_argument("--max_batch", type=int, default=4)
    p.add_argument("--device", default="cuda",
                   help="'cuda' (the card, default) or 'cpu' (every kernel's "
                        "plain version)")
    p.add_argument("--data_parallel", type=int, default=1,
                   help="ranks a round's rows split over (-1: every "
                        "visible GPU)")
    p.add_argument("--tensor_parallel", type=int, default=1,
                   help="ranks each UNet is split over (core/tp.py)")
    p.add_argument("--allow_cpu_mesh", action="store_true",
                   help="permit CPU ranks over gloo (tests only)")
    return p


def main(argv=None):
    import sys

    from imagdressing_tpu_torch.parallel import launch

    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_argparser().parse_args(argv)
    launch.run_app(main, argv, lambda mesh: _serve(args, mesh),
                   data_parallel=args.data_parallel,
                   tensor_parallel=args.tensor_parallel, device=args.device,
                   allow_cpu_mesh=args.allow_cpu_mesh)


def _serve(args, mesh):
    import os

    import torch.distributed as dist

    from imagdressing_tpu_torch.apps.loader import load_dressing_models
    from imagdressing_tpu_torch.apps.tokenizer import load_tokenizer
    from imagdressing_tpu_torch.core.config import PRESETS
    from imagdressing_tpu_torch.pipelines.dressing import DressingPipeline

    device = args.device if mesh is None else mesh.device
    preset = PRESETS[args.preset]
    models = load_dressing_models(
        base_dir=args.base_dir, vae_path=args.vae_path,
        image_encoder_path=args.image_encoder_path,
        model_ckpt=args.model_ckpt, device=device,
    )
    pipe = DressingPipeline(models, preset, device=device, mesh=mesh)
    if mesh is not None and mesh.size > 1:
        control = dist.new_group(backend="gloo")
        if mesh.rank != 0:
            follow(pipe, control)
            return
        pipe = MeshPipe(pipe, control)
    post = load_post_process(args.post_process, device) \
        if args.post_process else None
    tokenizer = load_tokenizer(os.path.join(args.base_dir, "tokenizer"))
    worker = InferenceWorker(pipe, tokenizer, max_batch=args.max_batch,
                             post_process=post)

    try:
        if args.ui == "gradio":
            run_gradio(worker, preset, args.server_port)
            return
        server = ThreadingHTTPServer(("0.0.0.0", args.server_port),
                                     make_handler(worker, preset))
        print(f"serving on :{args.server_port}", flush=True)
        server.serve_forever()
    finally:
        if isinstance(pipe, MeshPipe):
            pipe.close()


if __name__ == "__main__":
    main()
