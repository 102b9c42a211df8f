"""audian_torch's ``audian-songdetector`` against the JAX package's CLI on
the CPU: the same PCM-16 recording gives the same CSV table (both with the
same small ``_CHUNK``, so interior chunks take the decimating envelope),
and so do PCM-24 and float recordings, read through the port's
``AudioLoader``, and runs with ``-j`` and ``--mesh``; ``-c`` writes the
same configuration, malformed config values warn and keep the defaults,
and what the port cannot read stops with a message that names it.  The
viewer options ``-p`` / ``--plot-png`` are held in
``test_torch_songplot.py``."""

import numpy as np
import pytest
import torch

from audian_tpu.analysis import events as jev
from audian_tpu.cli import songdetector as jcli
from audian_tpu.data import wavio as jwav

from audian_torch.analysis import events as tev
from audian_torch.cli import songdetector as tcli

RATE = 24000.0


def _recording(nsongs=3, seed=12):
    """Chirpy songs (6.5 kHz carrier, 30 Hz AM) over noise on 2 channels,
    as the JAX package's song-detector tests make them."""
    rng = np.random.default_rng(seed)
    n = int((2.0 + 3.3 * nsongs) * RATE)
    t = np.arange(n) / RATE
    x = 0.02 * rng.standard_normal(n)
    for k in range(nsongs):
        sel = (t >= 2.0 + 3.3 * k) & (t < 3.2 + 3.3 * k)
        x[sel] += 0.6 * 0.5 * (1 + np.sin(2 * np.pi * 30.0 * t[sel])) \
            * np.sin(2 * np.pi * 6500.0 * t[sel])
    return np.stack([x, 0.5 * x], axis=1)


@pytest.fixture
def small_chunks(monkeypatch):
    for mod in (jev, tev):
        monkeypatch.setattr(mod, "_CHUNK", 1 << 15)
        monkeypatch.setattr(mod, "_KERNEL_BUDGET", {"filt": 0, "env": 0})


def test_cli_writes_the_same_table_as_jax(tmp_path, small_chunks):
    path = tmp_path / "songs16.wav"
    jwav.write_audio(path, _recording(), RATE, encoding="PCM_16")
    want, got = tmp_path / "jax.csv", tmp_path / "torch.csv"
    assert jcli.main(["-o", str(want), str(path)]) == 0
    assert tcli.main(["-o", str(got), str(path)], device="cpu") == 0
    lines = got.read_text().strip().splitlines()
    assert lines[0] == "channel,tstart/s,tend/s,duration/s"
    assert len(lines) == 1 + 2 * 3          # 3 songs x 2 channels
    assert got.read_text() == want.read_text()


@pytest.mark.parametrize("encoding", ["PCM_24", "FLOAT"])
def test_cli_reads_other_encodings_as_jax(tmp_path, small_chunks, encoding):
    path = tmp_path / f"songs-{encoding}.wav"
    jwav.write_audio(path, _recording(), RATE, encoding=encoding)
    data, rate = tcli.load_recording(path)
    assert data.dtype == np.float32 and rate == RATE
    want, got = tmp_path / "jax.csv", tmp_path / "torch.csv"
    assert jcli.main(["-o", str(want), str(path)]) == 0
    assert tcli.main(["-o", str(got), str(path)], device="cpu") == 0
    assert len(got.read_text().strip().splitlines()) == 1 + 2 * 3
    assert got.read_text() == want.read_text()


@pytest.mark.parametrize("encoding", ["PCM_16", "PCM_24"])
def test_cli_reads_flac_as_jax(tmp_path, small_chunks, encoding):
    """A 16-bit FLAC arrives as int16 codes (the raw route into detect),
    a 24-bit one as float32; both CSVs equal the JAX CLI's, and the 16-bit
    one equals the CSV of a WAV of the same codes."""
    path = tmp_path / "songs.flac"
    jwav.write_audio(path, _recording(), RATE, encoding=encoding)
    data, rate = tcli.load_recording(path)
    assert rate == RATE
    assert data.dtype == (np.int16 if encoding == "PCM_16" else np.float32)
    want, got = tmp_path / "jax.csv", tmp_path / "torch.csv"
    assert jcli.main(["-o", str(want), str(path)]) == 0
    assert tcli.main(["-o", str(got), str(path)], device="cpu") == 0
    assert len(got.read_text().strip().splitlines()) == 1 + 2 * 3
    assert got.read_text() == want.read_text()
    if encoding == "PCM_16":
        wav, csv = tmp_path / "songs.wav", tmp_path / "wav.csv"
        jwav.write_audio(wav, _recording(), RATE, encoding=encoding)
        assert tcli.main(["-o", str(csv), str(wav)], device="cpu") == 0
        assert csv.read_text() == got.read_text()


def test_cli_default_output_name(tmp_path, small_chunks, capsys):
    path = tmp_path / "rec.wav"
    jwav.write_audio(path, _recording(nsongs=1), RATE, encoding="PCM_16")
    assert tcli.main([str(path)], device="cpu") == 0
    out = tmp_path / "rec-songs.csv"
    assert len(out.read_text().strip().splitlines()) == 1 + 2
    assert f"{path}: 2 songs -> {tmp_path / 'rec'}-songs.csv" in \
        capsys.readouterr().out


def test_save_config_equals_jax(tmp_path):
    a, b = tmp_path / "jax.cfg", tmp_path / "torch.cfg"
    assert jcli.main(["-c", str(a)]) == 0
    assert tcli.main(["-c", str(b)], device="cpu") == 0
    assert b.read_text() == a.read_text()
    assert "highpassfreq: 1000.0Hz" in b.read_text()
    assert tcli.main(["-c", str(tmp_path / "bad.txt")], device="cpu") == 1


def test_config_tolerates_bad_values(tmp_path, capsys):
    cfg = tcli.default_config()
    want = cfg.value("minduration")
    bad = tmp_path / "songdetector.cfg"
    bad.write_text("minduration: abc\n"
                   "highpassfreq:\n"
                   "lowpassfreq: 9000Hz # inline comment\n")
    cfg.load(bad)
    err = capsys.readouterr().err
    assert "minduration" in err and "highpassfreq" in err
    assert cfg.value("minduration") == want
    assert cfg.value("lowpassfreq") == 9000.0
    # the cascade: the deepest directory wins
    d = tmp_path / "a" / "b"
    d.mkdir(parents=True)
    (tmp_path / "a" / "x.cfg").write_text("minduration: 0.3s\n")
    (d / "x.cfg").write_text("minduration: 0.2s\n")
    cfg = tcli.default_config()
    cfg.load_files("x.cfg", d / "data.wav", 3)
    assert cfg.value("minduration") == 0.2


@pytest.mark.parametrize("kind", ["float", "flac", "missing"])
def test_unreadable_input_names_the_loader(tmp_path, capsys, kind):
    """What the loader does not read stops with its reason: a 16-bit float
    WAV (an IEEE-float tag no reader decodes), a corrupt FLAC file (the
    JAX CLI's message), a missing file."""
    path = tmp_path / "rec.wav"
    if kind == "float":
        jwav.write_audio(path, _recording(nsongs=1), RATE, encoding="PCM_16")
        raw = bytearray(path.read_bytes())
        assert raw[12:16] == b"fmt "
        raw[20:22] = (3).to_bytes(2, "little")     # IEEE float, 16 bits
        path.write_bytes(bytes(raw))
    elif kind == "flac":
        path = tmp_path / "rec.flac"
        path.write_bytes(b"fLaC" + bytes(60))
    assert tcli.main([str(path)], device="cpu") == 1
    err = capsys.readouterr().err
    assert err.startswith("error: ") and str(path) in err
    if kind == "float":
        assert "unsupported encoding tag3/16" in err
    elif kind == "flac":
        assert "truncated FLAC stream" in err
        assert jcli.main([str(path)]) == 1
        assert capsys.readouterr().err == err


@pytest.mark.parametrize("args", [["-j", "2"], ["--mesh", "4"]])
def test_unported_options_stop_with_a_message(tmp_path, capsys, small_chunks,
                                              args):
    """The two options the port once refused, now working (the name is
    kept from then): ``-j 2`` over two recordings and ``--mesh 4`` write
    the JAX CLI's CSVs (the JAX run spreads the files over, or shards
    each recording across, its virtual CPU devices); on the CPU the port
    has one distinct device, so ``--mesh`` says it runs single-device
    (:func:`test_mesh_shards_over_four_devices_as_jax` shards)."""
    paths = []
    for k in range(2):
        path = tmp_path / f"rec{k}.wav"
        jwav.write_audio(path, _recording(nsongs=2 + k, seed=12 + k), RATE,
                         encoding="PCM_16")
        paths.append(str(path))
    assert jcli.main([*args, *paths]) == 0
    capsys.readouterr()
    want = [(tmp_path / f"rec{k}-songs.csv").read_text() for k in range(2)]
    for k in range(2):
        (tmp_path / f"rec{k}-songs.csv").unlink()
    assert tcli.main([*args, *paths], device="cpu") == 0
    err = capsys.readouterr().err
    got = [(tmp_path / f"rec{k}-songs.csv").read_text() for k in range(2)]
    assert got == want
    assert [len(t.strip().splitlines()) for t in got] == [1 + 2 * 2,
                                                         1 + 2 * 3]
    if args[0] == "--mesh":
        assert err.strip() == ("--mesh 4: only 1 device(s) available, "
                               "running single-device")


def test_mesh_shards_over_four_devices_as_jax(tmp_path, capsys, small_chunks,
                                              monkeypatch):
    """``--mesh 4`` with four devices at hand (the CPU four times) takes
    the CLI's sharded branch: each recording's envelope comes from the
    sequence-sharded detect, and the CSVs equal the JAX CLI's sharded
    run's."""
    from audian_torch.parallel import detect as tdetect

    monkeypatch.setattr(tcli, "local_devices",
                        lambda device=None: [torch.device("cpu")] * 4)
    sharded = []
    real = tdetect.sharded_band_env

    def spy(mesh, *args):
        env = real(mesh, *args)
        sharded.append((mesh.shape["seq"], env is not None))
        return env

    monkeypatch.setattr(tdetect, "sharded_band_env", spy)
    paths = []
    for k in range(2):
        path = tmp_path / f"rec{k}.wav"
        jwav.write_audio(path, _recording(nsongs=2 + k, seed=12 + k), RATE,
                         encoding="PCM_16")
        paths.append(str(path))
    assert jcli.main(["--mesh", "4", *paths]) == 0
    want = [(tmp_path / f"rec{k}-songs.csv").read_text() for k in range(2)]
    for k in range(2):
        (tmp_path / f"rec{k}-songs.csv").unlink()
    capsys.readouterr()
    assert tcli.main(["--mesh", "4", "-v", *paths], device="cpu") == 0
    out, err = capsys.readouterr()
    assert "sequence-sharding over 4 devices" in out and err == ""
    assert sharded == [(4, True)] * 2
    got = [(tmp_path / f"rec{k}-songs.csv").read_text() for k in range(2)]
    assert got == want
