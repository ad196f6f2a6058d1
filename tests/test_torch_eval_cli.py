"""The port's evaluation and data CLIs on the CPU, against the JAX package's:

- ``m4t_evaluate`` S2TT on the tiny HF checkpoint of
  tests/integration/test_evaluate_cli.py (built here the same way, both
  loaders in fp32): the hypotheses and the scores of JAX's CLI, the
  corrupted row empty, the native loader recorded in ``run_info.json``;
  ``m4t_evaluate`` S2ST with ``--compute_asr_bleu`` on the tiny ``.pt`` card
  of tests/test_torch_cli_predict.py: the port's own Transcriber scores the
  written WAVs; ``make_m4t_transcriber`` is the Translator's ASR;
- ``run_asr_bleu``, ``etox`` and ``asr_etox`` with stand-in transcribers and
  word lists: JAX's outputs; the port never downloads the SentencePiece model
  a language without word boundaries needs;
- ``expressivity_pauserate`` against JAX's and scipy's Spearman;
  ``prepare_mexpresso`` against JAX's ``build_en_manifest_from_oss``, and its
  ``main`` over stand-in dataset archives in the cache directory;
- ``prepare_dataset`` against JAX's CLI with the ``datasets`` builders
  stubbed (tests/test_torch_finetune_cli.py's stand-in);
- ``expressivity_evaluate`` on ``tiny_expressive`` and a tiny PRETSSEL
  (loaders patched): the Translator's and PretsselGenerator's outputs."""

import csv
import functools
import itertools
import json
import sys
import tarfile

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from seamless_communication_tpu.cli import asr_etox as jasr_etox
from seamless_communication_tpu.cli import eval_utils as jeu
from seamless_communication_tpu.cli import etox as jetox
from seamless_communication_tpu.cli import evaluate as jevaluate
from seamless_communication_tpu.cli import expressivity_pauserate as jpause
from seamless_communication_tpu.cli import loading as jloading
from seamless_communication_tpu.cli import prepare_dataset as jprep
from seamless_communication_tpu.cli import prepare_mexpresso as jmex
from seamless_communication_tpu.cli import run_asr_bleu as jrun_asr_bleu

from seamless_communication_torch.audio.wav import read_wav, resample, write_wav
from seamless_communication_torch.cli import (
    asr_etox, etox, eval_utils, evaluate, expressivity_evaluate, expressivity_pauserate,
    loading, prepare_dataset, prepare_mexpresso, run_asr_bleu,
)
from seamless_communication_torch.text.spm import (
    TYPE_CONTROL, TYPE_NORMAL, TYPE_UNKNOWN, build_spm_model,
)

from test_torch_cli_predict import card_dir, tiny_env  # noqa: F401 (fixtures)
from test_torch_finetune_cli import _fake_datasets


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Torch on one intra-op thread: the suite runs six workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def write_tsv(path, rows, fields=("audio", "tgt_text")):
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(fields), delimiter="\t")
        w.writeheader()
        w.writerows(rows)


def tone(i: int, seconds: float) -> np.ndarray:
    n = int(16000 * seconds)
    return (0.1 * np.sin(2 * np.pi * (250 + 50 * i) * np.arange(n) / 16000)).astype(
        np.float32)


@pytest.fixture(scope="module")
def hf_assets(tmp_path_factory):
    """The tiny HF SeamlessM4Tv2 checkpoint, SentencePiece file and card of
    tests/integration/test_evaluate_cli.py, and its manifest: three tones and
    a corrupted file in the second row."""
    from transformers import SeamlessM4Tv2Config, SeamlessM4Tv2Model

    d = tmp_path_factory.mktemp("eval_cli")
    torch.manual_seed(0)
    cfg = SeamlessM4Tv2Config(
        hidden_size=64, vocab_size=256, t2u_vocab_size=112, char_vocab_size=64,
        encoder_layers=2, decoder_layers=2,
        encoder_attention_heads=4, decoder_attention_heads=4,
        encoder_ffn_dim=128, decoder_ffn_dim=128,
        speech_encoder_layers=2, speech_encoder_attention_heads=4,
        speech_encoder_intermediate_size=128, conv_depthwise_kernel_size=7,
        left_max_position_embeddings=8, right_max_position_embeddings=3,
        speech_encoder_dropout=0.0, dropout=0.0, attention_dropout=0.0,
        activation_dropout=0.0, speech_encoder_hidden_act="swish",
        adaptor_kernel_size=8, adaptor_stride=8, adaptor_dropout=0.0,
        num_adapter_layers=1, feature_projection_input_dim=160,
        t2u_encoder_layers=2, t2u_decoder_layers=2,
        t2u_encoder_attention_heads=4, t2u_decoder_attention_heads=4,
        t2u_encoder_ffn_dim=128, t2u_decoder_ffn_dim=128,
        t2u_variance_predictor_embed_dim=64, t2u_variance_predictor_hidden_dim=32,
        t2u_variance_predictor_kernel_size=3, t2u_variance_pred_dropout=0.0,
        speech_encoder_chunk_size=None, position_embeddings_type="relative_key",
        unit_hifi_gan_vocab_size=112, upsample_initial_channel=32,
        upsample_rates=[4, 2], upsample_kernel_sizes=[8, 4],
        resblock_kernel_sizes=[3], resblock_dilation_sizes=[[1, 2]],
        unit_embed_dim=32, lang_embed_dim=8, spkr_embed_dim=8,
        vocoder_num_langs=4, vocoder_num_spkrs=4, var_pred_dropout=0.0,
        max_position_embeddings=512,
    )
    SeamlessM4Tv2Model(cfg).eval().save_pretrained(d / "hf")
    base = [("<unk>", 0.0, TYPE_UNKNOWN), ("<s>", 0.0, TYPE_CONTROL),
            ("</s>", 0.0, TYPE_CONTROL)]
    (d / "tok.model").write_bytes(build_spm_model(
        base + [(w, -2.0, TYPE_NORMAL) for w in ["▁aa", "▁bb", "▁cc", "▁dd"]]))
    (d / "cards").mkdir()
    (d / "cards" / "tiny_eval_test.yaml").write_text(
        "name: tiny_eval_test\nmodel_arch: tiny_v2\n"
        f"tokenizer: {d / 'tok.model'}\n"
        "langs:\n- eng\n- fra\nnum_units: 100\nunit_langs:\n- eng\n- fra\n")
    (d / "audio").mkdir()
    rows = []
    for i in range(3):
        write_wav(str(d / "audio" / f"{i}.wav"), tone(i, 0.4 + 0.2 * i), 16000)
        rows.append({"audio": f"audio/{i}.wav", "tgt_text": "aa bb"})
    (d / "audio" / "bad.wav").write_bytes(b"garbage, not audio")
    rows.insert(1, {"audio": "audio/bad.wav", "tgt_text": "cc"})
    write_tsv(d / "data.tsv", rows)
    return d


def test_m4t_evaluate_s2tt_matches_jax(hf_assets, monkeypatch):
    d = hf_assets
    monkeypatch.setenv("SEAMLESS_CARDS_DIR", str(d / "cards"))
    monkeypatch.setattr(jloading, "load_unity_model_and_tokenizers", functools.partial(
        jloading.load_unity_model_and_tokenizers, dtype=jnp.float32))
    monkeypatch.setattr(loading, "load_unity_model_and_tokenizers", functools.partial(
        loading.load_unity_model_and_tokenizers, dtype=torch.float32))
    common = [str(d / "data.tsv"), "s2tt", "eng", "--model_name", "tiny_eval_test",
              "--local_hf_path", str(d / "hf"), "--batch_size", "4",
              "--audio_root_dir", str(d)]
    monkeypatch.setattr(sys, "argv", ["m4t_evaluate", *common,
                                      "--output_path", str(d / "jax")])
    jevaluate.main()
    res = evaluate.main([*common, "--output_path", str(d / "port"), "--device", "cpu"])
    want = (d / "jax" / "hypotheses.txt").read_text()
    assert (d / "port" / "hypotheses.txt").read_text() == want
    assert res.hypotheses == want.split("\n") and len(res.hypotheses) == 4
    assert res.hypotheses[1] == ""              # the corrupted file
    assert json.loads((d / "port" / "s2tt_scores.json").read_text()) == json.loads(
        (d / "jax" / "s2tt_scores.json").read_text()) == res.metrics
    info = json.loads((d / "port" / "run_info.json").read_text())
    assert info == {"loader": "native", "rows": 4, "device": "cpu"} and res.loader == "native"


def test_m4t_evaluate_raises_when_the_model_fails(hf_assets, monkeypatch, tmp_path):
    """A failure of ``Translator.predict`` (on the card: a CUDA error, a
    kernel that does not build or launch, out of memory) ends the run: no
    batch turns into empty hypotheses and scores. The corrupted row needs no
    catch: its length 0 blanks it (``test_m4t_evaluate_s2tt_matches_jax``)."""
    from seamless_communication_torch.inference.translator import Translator

    def fail(self, *args, **kwargs):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    monkeypatch.setenv("SEAMLESS_CARDS_DIR", str(hf_assets / "cards"))
    monkeypatch.setattr(Translator, "predict", fail)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        evaluate.main([str(hf_assets / "data.tsv"), "s2tt", "eng", "--model_name",
                       "tiny_eval_test", "--local_hf_path", str(hf_assets / "hf"),
                       "--audio_root_dir", str(hf_assets), "--output_path",
                       str(tmp_path / "out"), "--device", "cpu"])
    assert not (tmp_path / "out" / "s2tt_scores.json").exists()


def test_m4t_evaluate_s2st_asr_bleu(tiny_env, tmp_path):
    """S2ST with ``--compute_asr_bleu``: no Whisper checkpoint, so the
    port's own Transcriber transcribes the written WAVs."""
    from seamless_communication_torch.inference.transcriber import Transcriber

    d = tiny_env
    for i in range(2):
        write_wav(str(tmp_path / f"{i}.wav"), tone(i, 0.5 + 0.3 * i), 16000)
    write_tsv(tmp_path / "data.tsv", [{"audio": f"{i}.wav", "tgt_text": "the cat sat"}
                                      for i in range(2)])
    res = evaluate.main([str(tmp_path / "data.tsv"), "s2st", "fra",
                         "--model_name", "tiny_pt_test", "--vocoder_name", "tiny_vocoder",
                         "--local_pt_path", str(d / "tiny.pt"), "--batch_size", "2",
                         "--audio_root_dir", str(tmp_path), "--output_path",
                         str(tmp_path / "out"), "--compute_asr_bleu", "--device", "cpu"])
    scores = json.loads((tmp_path / "out" / "s2st_asr_bleu.json").read_text())
    assert scores == res.metrics and scores["asr"] == "own_asr"
    tr = res.translator
    asr = Transcriber(tr.params, tr.cfg, tr.text_tokenizer, device="cpu")
    wavs = [resample(*read_wav(str(tmp_path / "out" / "wavs" / f"{i}.wav")), 16000)
            for i in range(2)]
    want = eval_utils.compute_asr_bleu(
        wavs, ["the cat sat"] * 2, lang="fra",
        transcribe=lambda ws: [asr.transcribe(w, "fra").text for w in ws])
    assert scores["asr_bleu"] == want


def test_make_m4t_transcriber(hf_assets, monkeypatch):
    """The port's M4T ASR callable: ``Translator.predict(..., "asr")`` in
    batches."""
    from seamless_communication_torch.inference.translator import Translator

    d = hf_assets
    monkeypatch.setenv("SEAMLESS_CARDS_DIR", str(d / "cards"))
    fn = eval_utils.make_m4t_transcriber("tiny_eval_test", lang="eng",
                                         local_hf_path=str(d / "hf"), batch_size=2,
                                         device="cpu")
    wavs = [tone(i, 0.4 + 0.1 * i) for i in range(3)]
    params, cfg, tok, units, chars = loading.load_unity_model_and_tokenizers(
        "tiny_eval_test", local_hf_path=str(d / "hf"), device="cpu")
    tr = Translator(params, cfg, tok, units, chars, device="cpu")
    want = tr.predict(wavs[:2], "asr", "eng")[0] + tr.predict(wavs[2:], "asr", "eng")[0]
    assert fn(wavs) == want


def stand_in(texts):
    """A transcriber factory whose callables return ``texts`` in turn, over
    all their calls."""
    cycle = itertools.cycle(texts)

    def make(*a, **kw):
        return lambda wavs: [next(cycle) for _ in wavs]
    return make


@pytest.mark.parametrize("asr", ["m4t", "whisper"])
def test_run_asr_bleu_matches_jax(tmp_path, monkeypatch, capsys, asr):
    gen = tmp_path / "gen"
    (gen / "wavs").mkdir(parents=True)
    for i in range(3):
        write_wav(str(gen / "wavs" / f"{i}.wav"), tone(i, 0.3), 22050 if i else 16000)
    refs = ["the cat sat on the mat", "hello there", "a dog barks"]
    write_tsv(tmp_path / "data.tsv", [{"audio": "x", "tgt_text": r} for r in refs])
    fake = stand_in(["The cat sat on a mat!", "hello there", "dogs bark"])
    for mod in (jeu, eval_utils):
        monkeypatch.setattr(mod, "make_m4t_transcriber", fake)
        monkeypatch.setattr(mod, "make_whisper_transcriber", fake)
    argv = [str(gen), str(tmp_path / "data.tsv"), "--tgt_lang", "eng"]
    if asr == "whisper":
        argv += ["--whisper_model", "local-whisper"]
    monkeypatch.setattr(sys, "argv", ["run_asr_bleu", *argv])
    jrun_asr_bleu.main()
    want = json.loads(capsys.readouterr().out.strip())
    got = run_asr_bleu.main([*argv, "--output", str(tmp_path / "s.json"), "--device", "cpu"])
    assert got == want and got["num_utterances"] == 3 and 0 < got["asr_bleu"] < 100
    assert json.loads((tmp_path / "s.json").read_text()) == got


@pytest.fixture()
def word_lists(tmp_path):
    d = tmp_path / "twl"
    d.mkdir()
    (d / "eng_twl.txt").write_text("badword\nevil phrase\n")
    (d / "fra_twl.txt").write_text("méchant\n")
    return d


@pytest.mark.parametrize("lang", ["eng", "fra"])
def test_etox_matches_jax(tmp_path, monkeypatch, word_lists, lang):
    lines = "hello there\nso badword much\nan evil phrase, un méchant mot\n\n"
    (tmp_path / "in.txt").write_text(lines)
    monkeypatch.setattr(sys, "argv", ["etox", lang, str(tmp_path / "in.txt"),
                                      str(tmp_path / "jax.tsv"), "--etox_dataset",
                                      str(word_lists)])
    jetox.main()
    etox.main([lang, str(tmp_path / "in.txt"), str(tmp_path / "port.tsv"),
               "--etox_dataset", str(word_lists)])
    got = (tmp_path / "port.tsv").read_text()
    assert got == (tmp_path / "jax.tsv").read_text()
    assert got.splitlines()[0] == "text\ttoxicity\tbad_words"
    assert ("\t1\tbadword" in got) == (lang == "eng")


def test_etox_never_downloads(tmp_path, monkeypatch, word_lists):
    """A language without word boundaries needs the mintox card's
    SentencePiece model: not on disk, so the port raises."""
    monkeypatch.setenv("SEAMLESS_CACHE", str(tmp_path / "empty_cache"))
    (word_lists / "cmn_twl.txt").write_text("坏\n")
    with pytest.raises(FileNotFoundError, match="not a local file"):
        etox.main(["cmn", "--etox_dataset", str(word_lists)])


@pytest.mark.parametrize("model", ["seamlessM4T_v2_large", "whisper_local"])
def test_asr_etox_matches_jax(tmp_path, monkeypatch, word_lists, model):
    for i in range(3):
        write_wav(str(tmp_path / f"{i}.wav"), tone(i, 0.2), 16000)
    write_tsv(tmp_path / "data.tsv", [{"audio": f"{i}.wav"} for i in range(3)],
              fields=("audio",))
    fake = stand_in(["so badword much", "clean", "an evil phrase here"])
    for mod in (jeu, eval_utils):
        monkeypatch.setattr(mod, "make_m4t_transcriber", fake)
        monkeypatch.setattr(mod, "make_whisper_transcriber", fake)
    argv = ["--lang", "eng", "--audio_root_dir", str(tmp_path), "--model_name", model,
            "--batch_size", "2", "--etox_dataset", str(word_lists)]
    monkeypatch.setattr(sys, "argv", ["asr_etox", str(tmp_path / "data.tsv"),
                                      str(tmp_path / "jax.tsv"), *argv])
    jasr_etox.main()
    asr_etox.main([str(tmp_path / "data.tsv"), str(tmp_path / "port.tsv"), *argv,
                   "--device", "cpu"])
    got = (tmp_path / "port.tsv").read_text()
    assert got == (tmp_path / "jax.tsv").read_text()
    assert got.count("\n") == 4 and "\t2\tbadword,evil phrase" not in got
    assert "so badword much\t1\tbadword" in got and "an evil phrase here\t1\tevil phrase" in got


def test_pauserate_matches_jax(tmp_path, capsys):
    pause = tmp_path / "pause.tsv"
    pause.write_text("total_weight\twmean_duration_score\twmean_alignment_score\t"
                     "wmean_joint_score\n1.0\t0.5\t0.6\t0.4\n3.0\t0.9\t0.2\t0.8\n")
    rng = np.random.default_rng(0)
    src = rng.random(20)
    tgt = np.round(src * 2.0 + rng.random(20) * 0.1, 1)     # ties in the target
    s_tsv, t_tsv = tmp_path / "src.tsv", tmp_path / "tgt.tsv"
    for path, vals in ((s_tsv, src), (t_tsv, tgt)):
        path.write_text("id\tspeech_rate_syllable\n" + "\n".join(
            f"u{i}\t{v}" for i, v in enumerate(vals)))
    assert expressivity_pauserate.get_pause(str(pause)) == jpause.get_pause(str(pause))
    got = expressivity_pauserate.get_rate(str(t_tsv), str(s_tsv))
    assert got == jpause.get_rate(str(t_tsv), str(s_tsv))
    import scipy.stats
    assert got == pytest.approx(scipy.stats.spearmanr(src, tgt).correlation, abs=1e-9)
    out = expressivity_pauserate.main(["--pause_data_tsv", str(pause), "--target_speech_tsv",
                                       str(t_tsv), "--source_speech_tsv", str(s_tsv)])
    assert json.loads(capsys.readouterr().out) == out and out["rate_spearman"] == got


def expresso_tree(root):
    """A synthetic Expresso layout: three read utterances at 48 kHz, one of
    a style outside the whitelist."""
    uids = [("ex01_happy_00001", "hello <laugh> there"),
            ("ex01_whisper_00002", "<breath> soft words"),
            ("ex02_angry_00003", "not in whitelist")]
    lines = []
    for uid, text in uids:
        spk, style = uid.split("_")[0], uid.split("_")[1]
        wav_dir = root / "audio_48khz" / "read" / spk / style / "base"
        wav_dir.mkdir(parents=True, exist_ok=True)
        write_wav(str(wav_dir / f"{uid}.wav"), np.zeros(4800, np.float32) + 0.01 * len(uid),
                  48000)
        lines.append(f"{uid}\t{text}")
    (root / "read_transcriptions.txt").write_text("\n".join(lines) + "\n")


def test_prepare_mexpresso_manifest_matches_jax(tmp_path):
    expresso_tree(tmp_path / "expresso")
    rows = {}
    for name, mod in (("jax", jmex), ("port", prepare_mexpresso)):
        out = tmp_path / name
        got = mod.build_en_manifest_from_oss(tmp_path / "expresso", out)
        rows[name] = [{k: v.replace(str(out), "OUT") for k, v in r.items()} for r in got]
        rows[name + "_wavs"] = [read_wav(r["audio"]) for r in got]
    assert rows["port"] == rows["jax"]
    assert [r["text"] for r in rows["port"]] == ["hello there", "soft words"]
    for (w, sr), (jw, jsr) in zip(rows["port_wavs"], rows["jax_wavs"]):
        assert sr == jsr == 16000 and w.shape == (1600,) and np.array_equal(w, jw)


def test_prepare_mexpresso_main_from_cached_archives(tmp_path):
    """``main`` over the two dataset archives in ``--cache-dir``
    (``resolve_asset`` finds them by the cards' URL file names): one TSV a
    subset and language, the released rows joined with the English ones."""
    expresso_tree(tmp_path / "src" / "expresso")
    mex = tmp_path / "src" / "mexpresso_text"
    mex.mkdir()
    for subset in ("dev", "test"):
        for lang in prepare_mexpresso.MEXPRESSO_LANGS:
            (mex / f"{subset}_mexpresso_{lang}.tsv").write_text(
                f"id\ttext\nex01_happy_00001\t{lang} {subset} one\n")
    cache = tmp_path / "cache"
    cache.mkdir()
    for name in ("expresso", "mexpresso_text"):
        with tarfile.open(cache / f"{name}.tar", "w") as tf:
            tf.add(tmp_path / "src" / name, arcname=name)
    prepare_mexpresso.main([str(tmp_path / "out"), "--cache-dir", str(cache)])
    with open(tmp_path / "out" / "test_mexpresso_eng_fra.tsv") as f:
        got = list(csv.DictReader(f, delimiter="\t"))
    assert got == [{"id": "ex01_happy_00001",
                    "src_audio": str(tmp_path / "out" / "En_Expresso" / "audio_16khz_wav"
                                     / "ex01" / "ex01_happy_00001.wav"),
                    "src_speaker": "ex01", "src_text": "hello there", "src_lang": "eng",
                    "tgt_text": "fra test one", "tgt_lang": "fra", "label": "happy"}]
    assert len(list((tmp_path / "out").glob("*_mexpresso_eng_*.tsv"))) == 10


@pytest.mark.parametrize("name", ["google/fleurs", "speechcolab/gigaspeech"])
def test_prepare_dataset_matches_jax(tmp_path, monkeypatch, name):
    monkeypatch.setitem(sys.modules, "datasets", _fake_datasets())
    monkeypatch.delenv("HF_TOKEN", raising=False)
    args = ["--name", name, "--max_samples", "5"]
    args += (["--source_lang", "eng", "--target_lang", "fra", "--split", "test"]
             if name == "google/fleurs" else ["--split", "xs", "--huggingface_token", "t"])
    monkeypatch.setattr(sys, "argv", ["prepare_dataset", *args, "--save_dir",
                                      str(tmp_path / "jax")])
    jprep.main()
    manifest = prepare_dataset.main([*args, "--save_dir", str(tmp_path / "port"),
                                     "--device", "cpu"])
    split = "test" if name == "google/fleurs" else "xs"
    jtext = (tmp_path / "jax" / f"{split}_manifest.json").read_text()
    text = open(manifest).read()
    assert text.replace(str(tmp_path / "port"), "D") == jtext.replace(
        str(tmp_path / "jax"), "D")
    assert text.count("\n") >= 2


def test_prepare_dataset_checks_its_flags(tmp_path):
    for argv in (["--save_dir", str(tmp_path)],
                 ["--source_lang", "eng", "--target_lang", "fra", "--save_dir", str(tmp_path),
                  "--extract_units"],
                 ["--name", "speechcolab/gigaspeech", "--save_dir", str(tmp_path)]):
        with pytest.raises(SystemExit):
            prepare_dataset.main(argv)


def test_expressivity_evaluate(tmp_path, monkeypatch):
    """The CLI over ``tiny_expressive`` and a tiny PRETSSEL: each row's
    hypothesis and 16-bit WAV are those of the port's Translator (the prosody
    input the gcmvn-normalised fbank) and PretsselGenerator."""
    from seamless_communication_torch.audio.fbank import fbank_numpy
    from seamless_communication_torch.inference.pretssel_generator import PretsselGenerator
    from seamless_communication_torch.inference.translator import Translator
    from seamless_communication_torch.models.unity import model as tunity
    from seamless_communication_torch.models.unity.builder import get_arch
    from seamless_communication_torch.models.unity.unit_tokenizer import UnitTokenizer
    from seamless_communication_torch.text.char_tokenizer import CharTokenizer
    from seamless_communication_torch.text.nllb import NllbTokenizer
    from seamless_communication_torch.text.spm import SentencePieceModel

    from test_torch_pretssel import make_pretssel, tcfg
    from test_torch_translator_s2st import CHAR_SPM, LANGS, TEXT_SPM

    cfg = get_arch("tiny_expressive")
    unity = tunity.unity_init(torch.Generator().manual_seed(5), cfg)
    toks = (NllbTokenizer(SentencePieceModel.from_bytes(TEXT_SPM), langs=LANGS),
            UnitTokenizer(100, ["eng", "fra"], "tiny_expressive"),
            CharTokenizer(SentencePieceModel.from_bytes(CHAR_SPM)))
    _, voc = make_pretssel(4)
    rng = np.random.default_rng(2)
    mc = {"langs": ["eng", "fra"],
          "gcmvn_stats": {"mean": rng.normal(10, 2, 80).tolist(),
                          "std": rng.uniform(3, 5, 80).tolist()}}
    monkeypatch.setattr(loading, "load_unity_model_and_tokenizers",
                        lambda *a, **kw: (unity, cfg, *toks))
    monkeypatch.setattr(loading, "load_pretssel_vocoder",
                        lambda *a, **kw: (voc, tcfg(), mc, 16000))
    for i in range(2):
        write_wav(str(tmp_path / f"{i}.wav"), (rng.standard_normal(16000 + 4000 * i)
                                               * 0.1).astype(np.float32), 16000)
    write_tsv(tmp_path / "data.tsv", [{"audio": f"{i}.wav", "tgt_text": "x"}
                                      for i in range(2)])
    hyps = expressivity_evaluate.main([str(tmp_path / "data.tsv"), "--tgt_lang", "fra",
                                       "--audio_root_dir", str(tmp_path), "--output_path",
                                       str(tmp_path / "out"), "--device", "cpu"])
    assert (tmp_path / "out" / "hypotheses.txt").read_text().split("\n") == hyps
    tr = Translator(unity, cfg, *toks, device="cpu")
    gen = PretsselGenerator(voc, tcfg(), lang_to_index={"eng": 0, "fra": 1},
                            sample_rate=16000, device="cpu")
    mean, std = (np.asarray(mc["gcmvn_stats"][k]) for k in ("mean", "std"))
    for i in range(2):
        wav, _ = read_wav(str(tmp_path / f"{i}.wav"))
        g = ((fbank_numpy(wav) - mean[None]) / std[None]).astype(np.float32)
        texts, speech = tr.predict(wav, "s2st", "fra", prosody_encoder_input=g)
        want = gen.predict(speech.units, "fra", g[None], np.array([g.shape[0]]))[0]
        got, rate = read_wav(str(tmp_path / "out" / "wavs" / f"{i}.wav"))
        assert hyps[i] == texts[0] and rate == 16000 and got.shape == want.shape
        pcm = (np.clip(want, -1, 1) * 32767.0).astype(np.int16) / 32768.0
        np.testing.assert_allclose(got, pcm, atol=1.0 / 32768 + 1e-6)
