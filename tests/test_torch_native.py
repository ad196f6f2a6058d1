"""The port's native binding (``native.py``) against the JAX package's
``native.py`` (the same C++ sources: the JAX package loads its tracked build,
the port builds its own into ``_build/``) and against the port's numpy and
Python paths: the cases of tests/unit/test_native.py. fbank, WAV decode, the
threaded loader (batches, padding, corrupted files, resampling) and the
SentencePiece encoder equal JAX's binding exactly; fbank within 1e-3 of the
numpy fbank, the loader within 1e-4 of it on PCM16 input, the encoder equal
to the Python Viterbi on a vocabulary without duplicate pieces. A failed
build raises with the compiler's output; the serving layer's WAV decoding
goes through the binding."""

import base64
import io
import random
import wave

import numpy as np
import pytest

from seamless_communication_tpu import native as jnative

from seamless_communication_torch import native
from seamless_communication_torch.audio.fbank import fbank_numpy
from seamless_communication_torch.audio.wav import read_wav, resample, write_wav
from seamless_communication_torch.text.spm import (
    TYPE_BYTE, TYPE_CONTROL, TYPE_NORMAL, TYPE_UNKNOWN, TYPE_USER_DEFINED,
    SentencePieceModel, build_spm_model,
)


@pytest.fixture(scope="module")
def sig():
    rng = np.random.default_rng(3)
    t = np.arange(16000) / 16000.0
    return (0.4 * np.sin(2 * np.pi * 440 * t)
            + 0.05 * rng.standard_normal(16000)).astype(np.float32)


def pcm16(wav: np.ndarray) -> np.ndarray:
    """The waveform after a 16-bit WAV round trip."""
    return ((np.clip(wav, -1, 1) * 32767.0).astype(np.int16) / 32768.0).astype(np.float32)


def test_library_builds_into_the_port(tmp_path):
    """The port's library: in ``_build/``, named by the sources' hash, not
    the JAX package's tracked build."""
    path = native.library_path()
    assert path.parent == native.BUILD_DIR and path.name.startswith("libseamless_native-")
    native.get_lib()
    assert path.exists()
    assert "native/build" not in str(path)


def test_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "CXX_FLAGS", (*native.CXX_FLAGS, "-fno-such-option"))
    with pytest.raises(RuntimeError, match="(?s)native library build failed.*no-such-option"):
        native.build()
    assert not list(tmp_path.iterdir())


@pytest.mark.parametrize("seconds", [1.0, 0.0249, 0.37])
def test_fbank_matches_jax_and_numpy(sig, seconds):
    wav = sig[:int(seconds * 16000)]
    got = native.fbank_native(wav)
    want = jnative.fbank_native(wav)
    assert got.shape == want.shape == fbank_numpy(wav).shape
    assert np.array_equal(got, want)
    if got.size:
        np.testing.assert_allclose(got, fbank_numpy(wav), atol=1e-3, rtol=1e-4)


@pytest.mark.parametrize("rate", [16000, 22050])
def test_wav_decode_matches_jax_and_read_wav(tmp_path, sig, rate):
    p = tmp_path / "x.wav"
    write_wav(str(p), sig, rate)
    wav, got_rate = native.wav_decode_native(p.read_bytes())
    jwav, jrate = jnative.wav_decode_native(p.read_bytes())
    assert got_rate == jrate == rate
    assert np.array_equal(wav, jwav)
    ref, ref_rate = read_wav(str(p))
    assert ref_rate == rate
    np.testing.assert_allclose(wav, ref, atol=1e-6)
    np.testing.assert_allclose(wav, sig, atol=2e-4)
    assert native.wav_decode_native(b"not a wav") is None


def test_loader_batches_match_jax_and_numpy(tmp_path):
    """File order, padding to the bucket, lengths, a corrupted file at
    length 0; every batch equal to JAX's loader's."""
    rng = np.random.default_rng(0)
    paths, quantized = [], {}
    for i in range(7):
        n = int(16000 * (0.4 + 0.25 * i))
        wav = (0.1 * np.sin(2 * np.pi * (200 + 20 * i) * np.arange(n) / 16000)
               + 0.01 * rng.standard_normal(n)).astype(np.float32)
        p = tmp_path / f"{i}.wav"
        write_wav(str(p), wav, 16000)
        quantized[str(p)] = pcm16(wav)
        paths.append(str(p))
    bad = tmp_path / "bad.wav"
    bad.write_bytes(b"not a wav at all")
    paths.insert(3, str(bad))

    kw = dict(batch_size=3, n_mels=80, bucket=64, n_threads=4)
    loader = native.NativeFbankLoader(paths, **kw)
    jloader = jnative.NativeFbankLoader(paths, **kw)
    idx = 0
    for (fb, lens), (jfb, jlens) in zip(loader, jloader):
        assert np.array_equal(fb, jfb) and np.array_equal(lens, jlens)
        assert fb.shape[1] % 64 == 0
        for b in range(fb.shape[0]):
            if paths[idx] == str(bad):
                assert lens[b] == 0
            else:
                ref = fbank_numpy(quantized[paths[idx]])
                assert lens[b] == ref.shape[0]
                np.testing.assert_allclose(fb[b, :lens[b]], ref, atol=1e-4)
                assert np.all(fb[b, lens[b]:] == 0)
            idx += 1
    assert idx == len(paths)
    with pytest.raises(StopIteration):
        next(loader)
    loader.close()
    jloader.close()


def test_loader_resamples_as_jax(tmp_path):
    """A 22.05 kHz file is resampled in C++: JAX's loader's features exactly,
    and close to the port's polyphase path (another resampler family)."""
    rng = np.random.default_rng(1)
    n = int(22050 * 0.7)
    wav = (0.1 * np.sin(2 * np.pi * 300 * np.arange(n) / 22050)
           + 0.02 * rng.standard_normal(n)).astype(np.float32)
    p = tmp_path / "x22k.wav"
    write_wav(str(p), wav, 22050)
    ref = fbank_numpy(resample(pcm16(wav), 22050, 16000))
    fb, lens = next(iter(native.NativeFbankLoader([str(p)], batch_size=1)))
    jfb, jlens = next(iter(jnative.NativeFbankLoader([str(p)], batch_size=1)))
    assert np.array_equal(fb, jfb) and np.array_equal(lens, jlens)
    assert abs(int(lens[0]) - ref.shape[0]) <= 1
    L = min(int(lens[0]), ref.shape[0])
    assert float(np.abs(fb[0, :L] - ref[:L]).mean()) < 0.05


def test_spm_encoder_matches_jax_and_python():
    """The C++ Viterbi on unknowns, byte fallback, CJK and whitespace: the
    port's binding, JAX's binding and the port's Python encoder agree on a
    vocabulary without duplicate pieces."""
    random.seed(0)
    pieces = [("<unk>", 0.0, TYPE_UNKNOWN), ("<s>", 0.0, TYPE_CONTROL),
              ("</s>", 0.0, TYPE_CONTROL)]
    pieces += [(f"<0x{b:02X}>", -20.0, TYPE_BYTE) for b in range(256)]
    syll = ["ab", "ba", "ca", "na", "to", "ri", "ku", "mi"]
    vocab = sorted({("▁" if i % 2 else "") + "".join(
        random.choice(syll) for _ in range(random.randint(1, 3)))
        for i in range(300)} | {"▁日本語", "日本", "語", "ø", "▁Ω"})
    pieces += [(w, -random.uniform(1, 12), TYPE_NORMAL) for w in vocab]
    pieces += [(",", -5.0, TYPE_USER_DEFINED)]
    assert len({p for p, _, _ in pieces}) == len(pieces)

    spm = SentencePieceModel.from_bytes(build_spm_model(pieces))
    enc = native.NativeSpmEncoder.from_model(spm)
    jenc = jnative.NativeSpmEncoder(spm.pieces, spm.scores, spm._matchable,
                                    spm._byte_ids, spm.unk_id)
    words = [p.lstrip("▁") for p in vocab[:50]]
    texts = [" ".join(random.choice(words) for _ in range(random.randint(1, 10)))
             for _ in range(60)]
    texts += ["", " ", "unknown𝄞glyph", "日本語 mixed ascii", "ø Ω,", "\t tabs\nnewlines  "]
    for t in texts:
        s = spm._normalize(t)
        got = enc.encode_normalized(s)
        assert got == jenc.encode_normalized(s) == spm.encode(t), repr(t)


def test_serving_decodes_wav_through_the_binding(sig, monkeypatch):
    """``inference/serving.py _decode_wav_b64`` reads a WAV through
    ``wav_decode_native`` (JAX's decode), and a file the binding does not
    take through ``wave``."""
    from seamless_communication_tpu.inference import serving as jserving

    from seamless_communication_torch.inference import serving

    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(22050)
        w.writeframes((np.clip(sig, -1, 1) * 32767).astype("<i2").tobytes())
    b64 = base64.b64encode(buf.getvalue()).decode()
    calls = []
    orig = serving.wav_decode_native

    def spy(data):
        calls.append(len(data))
        return orig(data)

    monkeypatch.setattr(serving, "wav_decode_native", spy)
    got = serving._decode_wav_b64(b64)
    assert calls == [len(buf.getvalue())]
    np.testing.assert_array_equal(got, jserving._decode_wav_b64(b64))
    monkeypatch.setattr(serving, "wav_decode_native", lambda data: None)
    np.testing.assert_allclose(serving._decode_wav_b64(b64), got, atol=1e-6)


def test_serve_builds_the_library_before_it_listens(monkeypatch):
    """``serve`` builds the WAV decoder's library before it binds its port,
    so no request waits on the compiler; a build that fails stops the
    server from starting instead of failing every audio request."""
    from seamless_communication_torch.inference import serving

    calls = []
    monkeypatch.setattr(native, "get_lib", lambda: calls.append("built"))
    srv = serving.serve(object(), port=0)
    try:
        assert calls == ["built"]
    finally:
        srv.shutdown()
        srv.batcher.close()

    def fail():
        raise RuntimeError("native library build failed: g++ not found")

    monkeypatch.setattr(native, "get_lib", fail)
    monkeypatch.setattr(serving, "ThreadingHTTPServer", lambda *a: pytest.fail("listened"))
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        serving.serve(object(), port=0)
