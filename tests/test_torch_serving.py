"""The port's serving layer (``inference/serving.py``,
``inference/text_translator.py``, ``cli/serve.py``) against the JAX package,
fp32 on the CPU, with the tiny_v2 model and toy tokenizers of
tests/integration/test_serving.py (the JAX parameters carried across by
``checkpoint/from_jax.py``), driven over a real socket:

- the dynamic batcher gathers three S2TT and two T2TT requests in one collect
  window into two groups, and each response's text equals JAX's
  ``Translator.predict`` on the same group (a group's decode length comes
  from its longest source);
- every route and error of the JAX test gives JAX's server's status code
  and body;
- ``_wav_bytes`` then ``_decode_wav_b64`` equals JAX's within 1e-7;
- ``TextTranslator`` gives JAX's ``TextTranslator``'s texts;
- ``cli.serve.make_server`` loads tiny ``.pt`` files written by the port's
  exporter and answers a request with the text of a Translator on the same
  tree."""

import base64
import functools
import io
import json
import threading
import urllib.error
import urllib.request
import wave

import numpy as np
import pytest
import torch

import jax

from seamless_communication_tpu.inference import serving as jserving
from seamless_communication_tpu.inference.generator import (
    SequenceGeneratorOptions as JOptions,
)
from seamless_communication_tpu.inference.text_translator import (
    TextTranslator as JTextTranslator,
)
from seamless_communication_tpu.inference.translator import Translator as JTranslator
from seamless_communication_tpu.models.unity import model as junity
from seamless_communication_tpu.models.unity.builder import get_arch as jget_arch
from seamless_communication_tpu.models.unity.unit_tokenizer import (
    UnitTokenizer as JUnitTokenizer,
)
from seamless_communication_tpu.text.char_tokenizer import CharTokenizer as JCharTokenizer
from seamless_communication_tpu.text.nllb import NllbTokenizer as JNllbTokenizer
from seamless_communication_tpu.text.spm import SentencePieceModel as JSpm

from seamless_communication_torch.checkpoint.fairseq_export import export_unity
from seamless_communication_torch.checkpoint.from_jax import (
    text_stack_from_jax, unity_params_from_jax,
)
from seamless_communication_torch.cli import loading
from seamless_communication_torch.cli import serve as serve_cli
from seamless_communication_torch.inference import serving
from seamless_communication_torch.inference.generator import SequenceGeneratorOptions
from seamless_communication_torch.inference.text_translator import TextTranslator
from seamless_communication_torch.inference.translator import Translator
from seamless_communication_torch.models.unity.builder import get_arch
from seamless_communication_torch.models.unity.unit_tokenizer import UnitTokenizer
from seamless_communication_torch.text.char_tokenizer import CharTokenizer
from seamless_communication_torch.text.nllb import NllbTokenizer
from seamless_communication_torch.text.spm import (
    TYPE_CONTROL, TYPE_NORMAL, TYPE_UNKNOWN, SentencePieceModel, build_spm_model,
)

BASE = [("<unk>", 0.0, TYPE_UNKNOWN), ("<s>", 0.0, TYPE_CONTROL),
        ("</s>", 0.0, TYPE_CONTROL)]
CHARS = ["▁"] + list("abc")
# 225 two-letter words: most ids of the tiny vocabulary (256) decode to a word
WORDS = ["▁" + a + b for a in "abcdefghijklmno" for b in "abcdefghijklmno"]
TEXT_SPM = build_spm_model(BASE + [(w, -2.0, TYPE_NORMAL) for w in WORDS])
CHAR_SPM = build_spm_model(BASE + [(c, -1.0, TYPE_NORMAL) for c in CHARS])
LANGS = ["__eng__", "__fra__"]
OPTS = dict(beam_size=2, soft_max_seq_len=(0, 10))
TEXTS = ["aa bb", "cc aa bb cc aa"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Torch on one intra-op thread: the suite runs six workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def wav_b64(wav: np.ndarray, rate: int = 16000) -> str:
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes((np.clip(wav, -1, 1) * 32767).astype("<i2").tobytes())
    return base64.b64encode(buf.getvalue()).decode()


def noise(seed: int, seconds: float) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal(int(seconds * 16000))
            * 0.1).astype(np.float32)


@pytest.fixture(scope="module")
def models():
    jparams = junity.unity_init(jax.random.PRNGKey(0), jget_arch("tiny_v2"))
    # a random final layer-norm scale: the random decoder then writes words
    # instead of repeating the language token (which decodes to nothing)
    ln = jparams["text_decoder"]["stack"]["layer_norm"]
    ln["scale"] = jax.numpy.asarray(np.random.default_rng(0).standard_normal(
        ln["scale"].shape).astype(np.float32))
    jt = JTranslator(jparams, jget_arch("tiny_v2"),
                     JNllbTokenizer(JSpm.from_bytes(TEXT_SPM), langs=LANGS),
                     JUnitTokenizer(100, ["eng", "fra"], "base_v2"),
                     JCharTokenizer(JSpm.from_bytes(CHAR_SPM)),
                     text_opts=JOptions(**OPTS))
    tok = NllbTokenizer(SentencePieceModel.from_bytes(TEXT_SPM), langs=LANGS)
    params = unity_params_from_jax(jax.tree.map(np.asarray, jparams))
    tt = Translator(params, get_arch("tiny_v2"), tok,
                    UnitTokenizer(100, ["eng", "fra"], "base_v2"),
                    CharTokenizer(SentencePieceModel.from_bytes(CHAR_SPM)),
                    text_opts=SequenceGeneratorOptions(**OPTS), device="cpu")
    return jparams, jt, params, tt


def post(port: int, obj, path: str = "/v1/translate"):
    data = obj if isinstance(obj, bytes) else json.dumps(obj).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=300) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def get(port: int, path: str):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=30) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_batcher_groups_equal_jax_predict(models):
    """Five concurrent requests in one collect window: the batcher runs one
    ``predict`` a (task, tgt_lang, src_lang) group, and each text equals JAX's
    ``Translator.predict`` on that group as the batcher formed it."""
    _, jt, _, tt = models
    calls = []
    predict = tt.predict

    def recording(inputs, task, tgt_lang, **kw):
        calls.append((list(inputs), task, tgt_lang, kw.get("src_lang")))
        return predict(inputs, task, tgt_lang, **kw)

    tt.predict = recording
    reqs = ([{"task": "s2tt", "tgt_lang": "eng", "audio_b64": wav_b64(noise(i, s))}
             for i, s in enumerate((1.0, 2.5, 1.7))]
            + [{"task": "t2tt", "tgt_lang": "fra", "src_lang": "eng", "text": t}
               for t in TEXTS])
    srv = serving.serve(tt, port=0, max_batch=len(reqs), max_wait_ms=3000)
    results = [None] * len(reqs)
    try:
        def work(i):
            results[i] = post(srv.server_address[1], reqs[i])

        threads = [threading.Thread(target=work, args=(i,)) for i in range(len(reqs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not any(t.is_alive() for t in threads)
    finally:
        srv.shutdown()
        srv.batcher.close()
        del tt.predict
    assert sorted((task, len(inputs)) for inputs, task, _, _ in calls) == [
        ("s2tt", 3), ("t2tt", 2)]
    assert all(code == 200 for code, _ in results), results
    got = {}
    for inputs, task, tgt_lang, src_lang in calls:
        want, _ = jt.predict(inputs, task, tgt_lang, src_lang=src_lang)
        for x, text in zip(inputs, want):
            got[x if isinstance(x, str) else x.tobytes()] = str(text)
    assert all(got.values())
    for req, (_, body) in zip(reqs, results):
        key = (req["text"] if "text" in req
               else serving._decode_wav_b64(req["audio_b64"]).tobytes())
        assert body == {"text": got[key]}


ERRORS = [
    ("post", {"task": "s2tt"}),                                   # no tgt_lang
    ("post", {"task": "t2tt", "tgt_lang": "fra", "text": "aa"}),  # no src_lang
    ("post", {"task": "s2tt", "tgt_lang": "eng", "audio_b64": "not-base64!!"}),
    ("post", {"task": "nope", "tgt_lang": "eng",
              "audio_b64": wav_b64(np.zeros(4000, np.float32))}),
    ("post", {"task": "s2tt", "tgt_lang": "eng"}),                # no payload
    ("post", b"{not json"),
    ("get", "/healthz"),
    ("get", "/nope"),
    ("post_path", "/v1/nope"),
    ("post_path", "/v1/stream/open"),                             # no stream pool
]


def test_routes_and_errors_equal_jax(models):
    """Each route and bad request of tests/integration/test_serving.py (and
    a few more) against the port's server and JAX's: the same status code
    and the same body."""
    jparams, jt, _, tt = models
    servers = {"port": serving.serve(tt, port=0), "jax": jserving.serve(jt, port=0)}
    got = {}
    try:
        for name, srv in servers.items():
            p = srv.server_address[1]
            got[name] = [get(p, arg) if kind == "get"
                         else post(p, {}, arg) if kind == "post_path"
                         else post(p, arg) for kind, arg in ERRORS]
    finally:
        for srv in servers.values():
            srv.shutdown()
            srv.batcher.close()
    assert got["port"] == got["jax"]
    codes = [c for c, _ in got["port"]]
    assert codes == [400, 400, 400, 500, 400, 400, 200, 404, 404, 503]
    assert "src_lang" in got["port"][1][1]["error"]
    assert "unknown task" in got["port"][3][1]["error"]


@pytest.mark.parametrize("rate", [16000, 22050])
def test_wav_round_trip_equals_jax(rate):
    wav = np.clip(noise(7, 1.3) * 3, -1.2, 1.2)
    data = serving._wav_bytes(wav, rate)
    assert data == jserving._wav_bytes(wav, rate)
    b64 = base64.b64encode(data).decode()
    got, want = serving._decode_wav_b64(b64), jserving._decode_wav_b64(b64)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)


def test_text_translator_equals_jax(models):
    jparams, _, params, _ = models
    cfg = jget_arch("tiny_v2").nllb
    jtok = JNllbTokenizer(JSpm.from_bytes(TEXT_SPM), langs=LANGS)
    want = JTextTranslator(jparams["text_encoder"], jparams["text_decoder"], cfg, jtok,
                           JOptions(**OPTS)).translate(TEXTS, "eng", "fra")
    np_tree = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    t = TextTranslator(text_stack_from_jax(np_tree(jparams["text_encoder"])),
                       text_stack_from_jax(np_tree(jparams["text_decoder"])),
                       get_arch("tiny_v2").nllb,
                       NllbTokenizer(SentencePieceModel.from_bytes(TEXT_SPM), langs=LANGS),
                       SequenceGeneratorOptions(**OPTS), device="cpu")
    assert t.translate(TEXTS, "eng", "fra") == want and all(want)


def test_cli_serve_from_pt(models, tmp_path, monkeypatch):
    """``make_server`` on a card naming ``.pt``-less tokenizers and a
    ``--local_pt_path`` written by the port's exporter, on the CPU, answers a
    T2TT request with the text of a Translator on the same tree."""
    _, _, params, _ = models
    torch.save({"model": export_unity(params)}, tmp_path / "tiny.pt")
    (tmp_path / "tok.model").write_bytes(TEXT_SPM)
    (tmp_path / "char.model").write_bytes(CHAR_SPM)
    (tmp_path / "tiny_serve_test.yaml").write_text(
        "name: tiny_serve_test\nmodel_type: unity\nmodel_arch: tiny_v2\n"
        f"tokenizer: {tmp_path / 'tok.model'}\nchar_tokenizer: {tmp_path / 'char.model'}\n"
        "langs: [eng, fra]\nnum_units: 100\nunit_langs: [eng, fra]\n")
    monkeypatch.setenv("SEAMLESS_CARDS_DIR", str(tmp_path))
    monkeypatch.setattr(loading, "load_unity_model_and_tokenizers", functools.partial(
        loading.load_unity_model_and_tokenizers, dtype=torch.float32))
    srv = serve_cli.make_server(["--model_name", "tiny_serve_test", "--local_pt_path",
                                 str(tmp_path / "tiny.pt"), "--no_speech_out",
                                 "--device", "cpu", "--port", "0"])
    try:
        code, body = post(srv.server_address[1], {"task": "t2tt", "tgt_lang": "fra",
                                                  "src_lang": "eng", "text": TEXTS[0]})
        served = srv.batcher.translator
    finally:
        srv.shutdown()
        srv.batcher.close()
    assert served.device == torch.device("cpu") and served.vocoder_params is None
    want, _ = Translator(params, get_arch("tiny_v2"), served.text_tokenizer,
                         device="cpu").predict(TEXTS[0], "t2tt", "fra", src_lang="eng")
    assert (code, body) == (200, {"text": want[0]}) and want[0]
