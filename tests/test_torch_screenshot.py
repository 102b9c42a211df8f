"""The port's view screenshots (``audian_torch.app.screenshot``) and the
``audian --screenshot`` path of ``audian_torch.cli.audian`` against the
JAX package's: the view's text chunks are byte-identical for the same
view, every chunk kind reads back the same, and a screenshot passed back
as the input restores its view."""

import struct
import types
import zlib

import matplotlib

matplotlib.use("Agg")

import numpy as np
import pytest

from audian_tpu.app import screenshot as jshot
from audian_tpu.cli import audian as jcli
from audian_tpu.data import wavio as jwav

from audian_torch.app import screenshot as tshot
from audian_torch.cli import audian as tcli

RATE = 8000.0


def _png(chunks=()):
    """A 1x1 grey PNG with ``chunks`` ((type, body) pairs) before IEND."""
    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", 1, 1, 8, 0, 0, 0, 0)
    out = b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
    out += chunk(b"IDAT", zlib.compress(b"\x00\x80"))
    for kind, body in chunks:
        out += chunk(kind, body)
    return out + chunk(b"IEND", b"")


def view(path, toffset=0.375, twindow=0.5, channels=(1, 3)):
    """What ``view_metadata`` reads of a browser."""
    return types.SimpleNamespace(
        data=types.SimpleNamespace(file_path=path), toffset=toffset,
        twindow=twindow, show_channels=list(channels))


@pytest.fixture(scope="module")
def wav(tmp_path_factory):
    rng = np.random.default_rng(5)
    x = 0.3 * rng.standard_normal((int(2.0 * RATE), 2))
    p = tmp_path_factory.mktemp("tshot") / "rec.wav"
    jwav.write_audio(p, x, RATE, encoding="PCM_16")
    return p


@pytest.mark.parametrize("path", ["/data/rec.wav", "/data/grillen-ä.wav",
                                  "/data/蟋蟀.wav"])
def test_view_chunks_are_the_jax_bytes(tmp_path, path):
    """tEXt where latin-1 holds the path, iTXt where it does not: the same
    bytes from both packages, and the same view read back."""
    b = view(path)
    assert tshot.view_metadata(b) == jshot.view_metadata(b)
    got, want = tmp_path / "t.png", tmp_path / "j.png"
    got.write_bytes(_png())
    want.write_bytes(_png())
    tshot.write_view_metadata(got, b)
    jshot.write_view_metadata(want, b)
    assert got.read_bytes() == want.read_bytes()
    assert tshot.parse_view_metadata(got) == jshot.parse_view_metadata(want)
    assert tshot.parse_view_metadata(got)["file"] == path


@pytest.mark.parametrize("chunks", [
    [(b"tEXt", b"Software\x00numpy")],
    [(b"zTXt", b"audian-file\x00\x00" + zlib.compress(b"/a.wav"))],
    [(b"zTXt", b"audian-file\x00\x00not zlib")],
    [(b"iTXt", b"audian-file\x00\x01\x00\x00\x00"
      + zlib.compress("/ä.wav".encode()))],
    [(b"iTXt", b"audian-file\x00\x01\x00\x00\x00garbage"),
     (b"tEXt", b"audian-toffset\x002.5")],
    [(b"iTXt", b"k\x00\x00\x00de\x00Key\x00wert")],
], ids=["text", "ztxt", "ztxt-corrupt", "itxt-zlib", "itxt-corrupt",
        "itxt-lang"])
def test_chunks_read_as_jax(tmp_path, chunks):
    p = tmp_path / "c.png"
    p.write_bytes(_png(chunks))
    assert tshot.read_png_metadata(p) == jshot.read_png_metadata(p)
    assert tshot.parse_view_metadata(p) == jshot.parse_view_metadata(p)


def test_not_a_png_is_refused_as_jax(tmp_path):
    p = tmp_path / "x.png"
    p.write_bytes(b"GIF89a")
    for mod in (tshot, jshot):
        with pytest.raises(ValueError, match="not a PNG"):
            mod.read_png_metadata(p)
        with pytest.raises(ValueError, match="not a PNG"):
            mod.write_view_metadata(p, view("/a.wav"))


def test_save_view_screenshot_embeds_the_view(wav, tmp_path):
    import matplotlib.pyplot as plt

    b = view(str(wav), 0.25, 1.0, (0,))
    metas = []
    for k, mod in enumerate((tshot, jshot)):
        fig = plt.figure(figsize=(2, 1))
        p = mod.save_view_screenshot(fig, b, tmp_path / f"s{k}.png")
        plt.close(fig)
        metas.append(mod.parse_view_metadata(p))
    assert metas[0] == metas[1] == {"file": str(wav), "toffset": 0.25,
                                    "twindow": 1.0, "channels": [0]}


def test_cli_screenshot_as_jax(wav, tmp_path, monkeypatch):
    """``main([wav, "--screenshot", png])`` writes the JAX CLI's view, and
    a screenshot of another view given as the input comes back with that
    view."""
    monkeypatch.chdir(tmp_path)      # no plugin files of the repo
    got, want = tmp_path / "t.png", tmp_path / "j.png"
    assert tcli.main([str(wav), "--screenshot", str(got)],
                     device="cpu") == 0
    assert jcli.main([str(wav), "--screenshot", str(want)]) == 0
    assert (tshot.parse_view_metadata(got)
            == jshot.parse_view_metadata(want))
    nav = tmp_path / "nav.png"
    nav.write_bytes(_png())
    tshot.write_view_metadata(nav, view(str(wav), 0.5, 0.25, (1,)))
    want_view = {"file": str(wav), "toffset": 0.5, "twindow": 0.25,
                 "channels": [1]}
    assert tshot.parse_view_metadata(nav) == want_view
    got2 = tmp_path / "t2.png"
    assert tcli.main([str(nav), "--screenshot", str(got2)],
                     device="cpu") == 0
    assert tshot.parse_view_metadata(got2) == want_view


def test_cli_reports_what_it_cannot_open_as_jax(tmp_path, monkeypatch,
                                                capsys):
    monkeypatch.chdir(tmp_path)
    bad = tmp_path / "broken.png"
    bad.write_bytes(b"not a png")
    args = [str(tmp_path / "missing.wav"), str(bad), "--screenshot",
            str(tmp_path / "x.png")]
    assert tcli.main(args, device="cpu") == 1
    got = capsys.readouterr().err
    assert jcli.main(list(args)) == 1
    want = capsys.readouterr().err
    assert got.splitlines()[0] == want.splitlines()[0]
    assert got.splitlines()[-1] == want.splitlines()[-1] == (
        "error: no recordings could be opened")


def test_cli_needs_the_card_by_default(wav, tmp_path, monkeypatch):
    """Without CUDA the port's ``audian`` raises: it has no CPU fallback."""
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA"):
        tcli.main([str(wav), "--screenshot", str(tmp_path / "x.png")])
