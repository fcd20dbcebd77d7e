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
from imagdressing_tpu_torch.train.data import clip_preprocess_np

MULTI_GPU_PENDING = (
    "--data_parallel / --tensor_parallel other than 1 wait for the port's "
    "multi-GPU slice (ROADMAP Queue 1, multi-GPU); run with one card")

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

    def submit(self, payload: Dict[str, Any]) -> Dict[str, Any]:
        req = _Request(payload)
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
            t0 = time.perf_counter()
            try:
                prompts = np.stack(
                    [self.tokenizer(r.payload["prompt"]) for r in batch])
                negatives = np.stack([
                    self.tokenizer(r.payload.get("negative_prompt",
                                                 iu.DEFAULT_NEGATIVE))
                    for r in batch])
                refs = np.concatenate([r.payload["ref_image"] for r in batch])
                clips = np.concatenate(
                    [r.payload["ref_clip_image"] for r in batch])
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
                    # the serving contract: uint8 readback, a quarter of the
                    # float bytes; _png_b64 consumes it as-is
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
            except Exception as e:  # noqa: BLE001 - report errors per request
                for r in batch:
                    if r.event.is_set():
                        continue  # already answered (a post_process failed
                        # on a LATER batch member): don't clobber
                    r.result = {"error": f"{type(e).__name__}: {e}"}
                    r.event.set()


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
            try:
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
                    garment_inputs(cloth, preset,
                                   worker.pipe.models.vision_cfg.image_size)
                payload.setdefault("prompt", iu.DEFAULT_PROMPT)
                result = worker.submit(payload)
                if "error" in result:
                    self._send(500, json.dumps(result).encode(),
                               "application/json")
                    return
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
                   help="only 1: multi-GPU serving is not ported yet")
    p.add_argument("--tensor_parallel", type=int, default=1,
                   help="only 1: multi-GPU serving is not ported yet")
    return p


def main(argv=None):
    import os

    args = build_argparser().parse_args(argv)
    if args.data_parallel != 1 or args.tensor_parallel != 1:
        raise SystemExit(MULTI_GPU_PENDING)

    from imagdressing_tpu_torch.apps.loader import load_dressing_models
    from imagdressing_tpu_torch.apps.tokenizer import load_tokenizer
    from imagdressing_tpu_torch.core.config import PRESETS
    from imagdressing_tpu_torch.pipelines.dressing import DressingPipeline

    preset = PRESETS[args.preset]
    post = load_post_process(args.post_process, args.device) \
        if args.post_process else None
    models = load_dressing_models(
        base_dir=args.base_dir, vae_path=args.vae_path,
        image_encoder_path=args.image_encoder_path,
        model_ckpt=args.model_ckpt, device=args.device,
    )
    pipe = DressingPipeline(models, preset, device=args.device)
    tokenizer = load_tokenizer(os.path.join(args.base_dir, "tokenizer"))
    worker = InferenceWorker(pipe, tokenizer, max_batch=args.max_batch,
                             post_process=post)

    if args.ui == "gradio":
        run_gradio(worker, preset, args.server_port)
        return

    server = ThreadingHTTPServer(("0.0.0.0", args.server_port),
                                 make_handler(worker, preset))
    print(f"serving on :{args.server_port}", flush=True)
    server.serve_forever()


if __name__ == "__main__":
    main()
