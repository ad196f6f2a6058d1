"""The port's finetune entry point and its data on the CPU, against the JAX
package:
- ``datasets/loader.py manifest_batches`` equals JAX's key by key on S2T,
  AR S2S and NAR S2S manifests (ints exactly, the fbank within 1e-5); the
  batches re-iterate; a missing ``units`` raises as JAX's does;
- ``datasets/huggingface.py`` writes JAX's manifests through the same
  stand-in ``datasets`` module (nothing downloads);
- the conformer-shaw exporter, converter and initialiser equal JAX's on a
  tiny exported ``.pt``; a mismatched config raises;
- ``cli.finetune.main`` on a tiny card (``--device cpu``) trains, writes its
  best-model and state directories, and its losses equal the port trainer's
  on JAX's loader batches; the same command in four gloo processes started
  as ``torchrun`` starts them (``--model_parallel 2``, data 0 -> 2) builds
  a (data 2, model 2) mesh and trains to the same losses within bf16's
  rounding."""

import json
import pickle
import sys
import types

import numpy as np
import pytest
import torch

import jax

from seamless_communication_tpu.audio.wav import write_wav as jwrite_wav
from seamless_communication_tpu.checkpoint import convert_fairseq2 as jconvert
from seamless_communication_tpu.checkpoint.fairseq_export import (
    export_conformer_shaw_fairseq1 as jexport_shaw, export_unity as jexport_unity,
)
from seamless_communication_tpu.datasets import huggingface as jhf
from seamless_communication_tpu.datasets.loader import manifest_batches as jbatches
from seamless_communication_tpu.models.unity import model as junity
from seamless_communication_tpu.models.unity.builder import get_arch as jget_arch
from seamless_communication_tpu.text.char_tokenizer import CharTokenizer as JCharTokenizer
from seamless_communication_tpu.text.nllb import NllbTokenizer as JNllbTokenizer
from seamless_communication_tpu.text.spm import SentencePieceModel as JSpm

from seamless_communication_torch.checkpoint import convert_fairseq2 as tconvert
from seamless_communication_torch.checkpoint.fairseq_export import (
    export_conformer_shaw_fairseq1,
)
from seamless_communication_torch.checkpoint.from_jax import unity_params_from_jax
from seamless_communication_torch.checkpoint.serialize import flat_tensors, load_params
from seamless_communication_torch.cli import finetune, loading
from seamless_communication_torch.datasets import huggingface as thf
from seamless_communication_torch.datasets.loader import manifest_batches
from seamless_communication_torch.models.unity.builder import get_arch
from seamless_communication_torch.text.char_tokenizer import CharTokenizer
from seamless_communication_torch.text.nllb import NllbTokenizer
from seamless_communication_torch.text.spm import (
    TYPE_CONTROL, TYPE_NORMAL, TYPE_UNKNOWN, SentencePieceModel, build_spm_model,
)
from seamless_communication_torch.train.trainer import (
    FinetuneParams, UnitYFinetune, named_leaves,
)

from tests import torch_gloo

BASE = [("<unk>", 0.0, TYPE_UNKNOWN), ("<s>", 0.0, TYPE_CONTROL), ("</s>", 0.0, TYPE_CONTROL)]
WORDS = ["aa", "bb", "cc", "ab"]
TEXT_SPM = build_spm_model(BASE + [("▁" + w, -2.0, TYPE_NORMAL) for w in WORDS])
CHAR_SPM = build_spm_model(BASE + [(c, -1.0, TYPE_NORMAL) for c in ["▁"] + list("abc")])
LANGS = ["__eng__", "__fra__"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def toks():
    return {"port": (NllbTokenizer(SentencePieceModel.from_bytes(TEXT_SPM), langs=LANGS),
                     CharTokenizer(SentencePieceModel.from_bytes(CHAR_SPM))),
            "jax": (JNllbTokenizer(JSpm.from_bytes(TEXT_SPM), langs=LANGS),
                    JCharTokenizer(JSpm.from_bytes(CHAR_SPM)))}


def write_manifest(d, name: str, n: int, seed: int, *, units: bool = True) -> str:
    """``n`` seeded WAVs of 0.3-0.6 s with texts of 1-3 words, units and
    per-char durations (a word of k letters is k + 1 chars with its space)."""
    rng = np.random.default_rng(seed)
    lines = []
    for i in range(n):
        wav = (rng.standard_normal(int(rng.integers(4800, 9600))) * 0.1).astype(np.float32)
        path = d / f"{name}{i}.wav"
        jwrite_wav(str(path), wav, 16000)
        words = [WORDS[j] for j in rng.integers(0, len(WORDS), int(rng.integers(1, 4)))]
        tgt = {"text": " ".join(words), "lang": "fra"}
        if units:
            durs = rng.integers(1, 4, sum(len(w) + 1 for w in words)).tolist()
            tgt["units"] = rng.integers(0, 90, int(sum(durs))).tolist()
            tgt["char_durations"] = durs
        lines.append(json.dumps({"source": {"audio_local_path": str(path), "lang": "eng"},
                                 "target": tgt}))
    path = d / f"{name}.json"
    path.write_text("\n".join(lines) + "\n")
    return str(path)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("manifests")
    return {"train": write_manifest(d, "train", 4, 0), "eval": write_manifest(d, "eval", 2, 1),
            "no_units": write_manifest(d, "plain", 2, 2, units=False), "dir": d}


@pytest.mark.parametrize("mode", ["s2t", "ar_s2s", "nar_s2s"])
def test_manifest_batches_equal_jax(toks, data, mode):
    kw = {"s2t": {}, "ar_s2s": {"load_units": True}, "nar_s2s": {"load_units": True}}[mode]
    got = manifest_batches(data["train"], toks["port"][0], batch_size=3, **kw,
                           char_tokenizer=toks["port"][1] if mode == "nar_s2s" else None)
    want = list(jbatches(data["train"], toks["jax"][0], batch_size=3, **kw,
                         char_tokenizer=toks["jax"][1] if mode == "nar_s2s" else None))
    epochs = [list(got), list(got)]
    assert len(epochs[0]) == len(epochs[1]) == len(want) == 2
    for a, b, w in zip(*epochs, want):
        assert set(a) == set(w)
        for k in w:
            wk = np.asarray(w[k])
            assert a[k].dtype == wk.dtype and a[k].shape == wk.shape, k
            if k == "fbank":
                np.testing.assert_allclose(a[k], wk, rtol=0, atol=1e-5)
            else:
                np.testing.assert_array_equal(a[k], wk, err_msg=k)
            np.testing.assert_array_equal(a[k], b[k])


def test_missing_units_raise_as_jax(toks, data):
    with pytest.raises(ValueError, match="target.units"):
        list(jbatches(data["no_units"], toks["jax"][0], batch_size=2, load_units=True))
    with pytest.raises(ValueError, match="target.units"):
        list(manifest_batches(data["no_units"], toks["port"][0], batch_size=2,
                              load_units=True))


def _fake_datasets() -> types.ModuleType:
    """A stand-in for the ``datasets`` package: FLEURS with three ids in
    each language (one without a pair) and GigaSpeech with two rows."""
    rng = np.random.default_rng(4)

    def audio():
        return {"array": (rng.standard_normal(4000) * 0.1).astype(np.float32),
                "sampling_rate": 16000}

    tables = {("google/fleurs", "eng"): [{"id": i, "audio": audio(), "transcription": t}
                                         for i, t in ((1, "aa bb"), (2, "cc"), (3, "ab"))],
              ("google/fleurs", "fra"): [{"id": i, "audio": audio(), "transcription": t}
                                         for i, t in ((2, "bb aa"), (1, "cc cc"), (7, "x"))],
              ("speechcolab/gigaspeech", "xs"): [
                  {"audio": audio(), "text": "HELLO <COMMA> WORLD <PERIOD>"},
                  {"audio": audio(), "text": "AA BB"}]}
    mod = types.ModuleType("datasets")
    mod.load_dataset = lambda name, config, split: tables[(name, config)]
    return mod


class _Units:
    def predict(self, wav):
        return [[int(v) for v in (np.abs(wav[:5]) * 100).astype(np.int64)]]


class _Aligner:
    def prepare_audio(self, wav):
        return wav

    def extract_units(self, wav):
        return [int(v) for v in (np.abs(wav[:6]) * 100).astype(np.int64)]

    def extract_alignment(self, units, text):
        return np.ones((1, len(text) + 1), np.int64), None


@pytest.mark.parametrize("builder", ["fleurs", "fleurs_units", "fleurs_aligner",
                                     "gigaspeech"])
def test_huggingface_builders_equal_jax(tmp_path, monkeypatch, builder):
    monkeypatch.setitem(sys.modules, "datasets", _fake_datasets())
    manifests = {}
    for name, mod in (("jax", jhf), ("port", thf)):
        out = tmp_path / name
        if builder == "gigaspeech":
            samples = mod.build_gigaspeech_asr("train", str(out), max_samples=5)
        else:
            kw = {"fleurs_units": {"unit_extractor": _Units()},
                  "fleurs_aligner": {"aligner": _Aligner()}}.get(builder, {})
            samples = mod.build_fleurs_s2s("eng", "fra", "test", str(out), **kw)
        mod.write_manifest(samples, str(tmp_path / f"{name}.json"))
        manifests[name] = (tmp_path / f"{name}.json").read_text().replace(str(out), "OUT")
        wavs = sorted(p.name for p in out.iterdir())
        manifests[name + "_wavs"] = [(w, (out / w).read_bytes()) for w in wavs]
    assert manifests["port"] == manifests["jax"] and manifests["port"].count("\n") >= 2
    assert manifests["port_wavs"] == manifests["jax_wavs"]


def test_conformer_shaw_init_equals_jax(tmp_path):
    """The exporter writes JAX's state dict; the converter and the
    initialiser give JAX's trees; another config raises."""
    pre = junity.unity_init(jax.random.PRNGKey(8), jget_arch("tiny_v2"))
    fresh = junity.unity_init(jax.random.PRNGKey(9), jget_arch("tiny_v2"))
    port_pre = unity_params_from_jax(jax.tree.map(np.asarray, pre))
    sd = export_conformer_shaw_fairseq1(port_pre["speech_encoder"])
    jsd = jexport_shaw(pre["speech_encoder"])
    assert set(sd) == set(jsd)
    for k in jsd:
        np.testing.assert_array_equal(sd[k].numpy(), jsd[k].numpy(), err_msg=k)
    torch.save({"model": sd}, tmp_path / "shaw.pt")
    loaded = tconvert.load_pt_state_dict(str(tmp_path / "shaw.pt"))
    got = tconvert.init_speech_encoder_from_conformer_shaw(
        unity_params_from_jax(jax.tree.map(np.asarray, fresh)), loaded)
    want = unity_params_from_jax(jax.tree.map(np.asarray, jconvert.init_speech_encoder_from_conformer_shaw(
        fresh, jconvert.load_pt_state_dict(str(tmp_path / "shaw.pt")))))
    g, w = flat_tensors(got), flat_tensors(want)
    assert set(g) == set(w)
    for k in w:
        assert torch.equal(g[k], w[k]), k
    for k, t in flat_tensors(port_pre["speech_encoder"]["encoder"]).items():
        assert torch.equal(g[f"speech_encoder.encoder.{k}"], t), k
    with pytest.raises(ValueError, match="does not match model config"):
        tconvert.init_speech_encoder_from_conformer_shaw(
            unity_params_from_jax(jax.tree.map(np.asarray, junity.unity_init(
                jax.random.PRNGKey(1), jget_arch("tiny_v1")))), loaded)


# ---------------------------------------------------------------------------
# the entry point
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def card(tmp_path_factory):
    d = tmp_path_factory.mktemp("card")
    params = junity.unity_init(jax.random.PRNGKey(0), jget_arch("tiny_v2"))
    torch.save({"model": jexport_unity(params)}, d / "tiny.pt")
    (d / "tok.model").write_bytes(TEXT_SPM)
    (d / "tiny_ft.yaml").write_text(
        "name: tiny_ft\nmodel_type: unity\nmodel_arch: tiny_v2\n"
        f"tokenizer: {d / 'tok.model'}\nlangs: [eng, fra]\nnum_units: 100\n")
    return d


def _argv(card, data, out: str, *extra) -> list:
    return ["--train_dataset", data["train"], "--eval_dataset", data["eval"],
            "--model_name", "tiny_ft", "--local_pt_path", str(card / "tiny.pt"),
            "--device", "cpu", "--batch_size", "2", "--max_epochs", "1",
            "--eval_steps", "2", "--learning_rate", "1e-3", "--warmup_steps", "1",
            "--save_model_to", f"{out}/best", "--save_state_to", f"{out}/state", *extra]


@pytest.fixture(scope="module")
def cli_runs(card, data, tmp_path_factory):
    """``main`` in this process, and in four gloo processes meanwhile."""
    out = tmp_path_factory.mktemp("ft")
    job = {"env": {"SEAMLESS_CARDS_DIR": str(card)},
           "argv": _argv(card, data, str(out / "mesh"), "--model_parallel", "2")}
    path = str(out / "job.pkl")
    with open(path, "wb") as f:
        pickle.dump(job, f)
    procs = torch_gloo.spawn(torch_gloo.cli_worker, path)
    try:
        mp = pytest.MonkeyPatch()
        mp.setenv("SEAMLESS_CARDS_DIR", str(card))
        try:
            res = finetune.main(_argv(card, data, str(out / "one")))
        finally:
            mp.undo()
    finally:
        torch_gloo.join(procs)
    return {"one": res, "mesh": torch_gloo.load_out(path), "dir": out}


def test_finetune_main_trains_and_saves(cli_runs, card, data, toks, monkeypatch):
    """Two steps and one eval: the losses equal the port trainer's on the
    same loaded tree and JAX's loader batches; the best model and the state
    load back leaf for leaf."""
    res, out = cli_runs["one"], cli_runs["dir"] / "one"
    tr = res.trainer
    assert res.final_step == 2 and len(tr.step_losses) == 2
    assert all(np.isfinite(tr.step_losses)) and np.isfinite(tr.best_eval)
    best = flat_tensors(load_params(str(out / "best")))
    mine = flat_tensors(tr.params)
    assert set(best) == set(mine)
    for k in mine:
        assert torch.equal(best[k], mine[k].detach()), k
    again = UnitYFinetune(tr.params, get_arch("tiny_v2"), tr.ft, device="cpu")
    assert again.restore_state(str(out / "state")) == 2
    assert again.best_eval == tr.best_eval
    for (_, a), (_, b) in zip(named_leaves(again.params), named_leaves(tr.params)):
        assert torch.equal(a, b)

    monkeypatch.setenv("SEAMLESS_CARDS_DIR", str(card))
    params, cfg, *_ = loading.load_unity_model_and_tokenizers(
        "tiny_ft", local_pt_path=str(card / "tiny.pt"), device="cpu")
    ref = UnitYFinetune(params, cfg, FinetuneParams(learning_rate=1e-3, warmup_steps=1),
                        device="cpu")
    batches = [{k: np.asarray(v) for k, v in b.items()}
               for b in jbatches(data["train"], toks["jax"][0], batch_size=2)]
    assert [float(ref.step(b)["loss"]) for b in batches] == tr.step_losses


def test_finetune_main_under_torchrun_gloo(cli_runs):
    """The same command in four processes with torchrun's environment:
    ``main`` starts the gloo group, data 0 becomes 2 with model 2, and the
    two steps' losses are the single process's within bf16's rounding
    (the split sums round differently)."""
    mesh, one = cli_runs["mesh"], cli_runs["one"].trainer
    assert mesh["world"] == 4 and mesh["mesh"] == {"data": 2, "model": 2}
    assert mesh["final_step"] == 2
    np.testing.assert_allclose(mesh["losses"], one.step_losses, rtol=2e-2)
    assert (cli_runs["dir"] / "mesh" / "best").is_dir()
    assert (cli_runs["dir"] / "mesh" / "state").is_dir()
