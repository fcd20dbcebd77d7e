"""`png_native_share.dress` on hand-made spans: the share of the traced
window's PNG reads that ran the C++ unfilter, leaving out non-PNG reads,
spans of other names and spans outside the window; nothing where no read
carries a `decoder` (a program without the attribute)."""

from types import SimpleNamespace

from test_bench_layout import metric_module


def _read(i, t0, decoder=None, name="image.read"):
    attrs = {"bytes": 10} if decoder is None else {"bytes": 10,
                                                   "decoder": decoder}
    return {"name": name, "id": i, "parent": None, "trace_id": None,
            "thread": 1, "t0": t0, "t1": t0 + 0.5, "attrs": attrs}


def _run(monkeypatch, every):
    from imagdressing_tpu_torch.core import profiling

    monkeypatch.setattr(profiling, "spans", lambda: every)
    return SimpleNamespace(tracer=SimpleNamespace(t_start=0.0, t_stop=10.0))


def test_png_native_share_reads_png_reads_in_the_window(monkeypatch):
    every = [_read(1, 1.0, "native"), _read(2, 2.0, "native"),
             _read(3, 3.0, "native"), _read(4, 4.0, "numpy"),
             _read(5, 5.0, "pil"),                      # not a PNG
             _read(6, 6.0, "numpy", name="image.write"),  # not a read
             _read(7, 12.0, "numpy")]                   # after the window
    share = metric_module("png_native_share.dress").read(
        _run(monkeypatch, every))
    assert share == 75.0


def test_png_native_share_reads_nothing_without_the_attribute(monkeypatch):
    mod = metric_module("png_native_share.dress")
    assert mod.read(_run(monkeypatch, [_read(1, 1.0), _read(2, 2.0)])) \
        is None
    assert mod.read(_run(monkeypatch, [_read(1, 1.0, "pil")])) is None
    assert mod.read(SimpleNamespace(tracer=None)) is None
