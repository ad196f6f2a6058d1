"""The port imports neither JAX nor the JAX package, and its entry points run
on the CPU only when asked."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]

_PROBE = r"""
import importlib, pkgutil, sys
import seamless_communication_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m in ("jax", "orbax") or m.startswith(("jax.", "jaxlib", "orbax.",
                                                      "seamless_communication_tpu")))
new = {"seamless_communication_torch.ops.fused_attention",
       "seamless_communication_torch.ops.kernels.flash_attention",
       "seamless_communication_torch.ops.remat",
       "seamless_communication_torch.train.loss",
       "seamless_communication_torch.train.lr",
       "seamless_communication_torch.train.trainer",
       "seamless_communication_torch.assets",
       "seamless_communication_torch.checkpoint.convert_fairseq2",
       "seamless_communication_torch.checkpoint.convert_hf",
       "seamless_communication_torch.checkpoint.fairseq_export",
       "seamless_communication_torch.checkpoint.serialize",
       "seamless_communication_torch.cli.loading",
       "seamless_communication_torch.cli.predict",
       "seamless_communication_torch.models.monotonic.model",
       "seamless_communication_torch.models.wav2vec2.incremental",
       "seamless_communication_torch.streaming.fused",
       "seamless_communication_torch.streaming.pipeline",
       "seamless_communication_torch.streaming.agents.common",
       "seamless_communication_torch.streaming.agents.detokenizer",
       "seamless_communication_torch.streaming.agents.offline_w2v_bert_encoder",
       "seamless_communication_torch.streaming.agents.online_feature_extractor",
       "seamless_communication_torch.streaming.agents.online_text_decoder",
       "seamless_communication_torch.streaming.agents.online_unit_decoder",
       "seamless_communication_torch.streaming.agents.online_vocoder",
       "seamless_communication_torch.streaming.agents.pretssel_vocoder",
       "seamless_communication_torch.models.unity.film",
       "seamless_communication_torch.models.pretssel.ecapa_tdnn",
       "seamless_communication_torch.models.pretssel.streamable",
       "seamless_communication_torch.models.pretssel.vocoder",
       "seamless_communication_torch.inference.pretssel_generator",
       "seamless_communication_torch.cli.expressivity_predict",
       "seamless_communication_torch.streaming.multi",
       "seamless_communication_torch.inference.serving",
       "seamless_communication_torch.inference.text_translator",
       "seamless_communication_torch.cli.serve",
       "seamless_communication_torch.parallel.collectives",
       "seamless_communication_torch.parallel.sharding",
       "seamless_communication_torch.parallel.pipeline",
       "seamless_communication_torch.datasets.loader",
       "seamless_communication_torch.datasets.huggingface",
       "seamless_communication_torch.cli.finetune",
       "seamless_communication_torch.models.unit_extractor.wav2vec2_raw",
       "seamless_communication_torch.models.unit_extractor.unit_extractor",
       "seamless_communication_torch.models.aligner.model",
       "seamless_communication_torch.models.aligner.extractor",
       "seamless_communication_torch.toxicity.mutox",
       "seamless_communication_torch.toxicity.mutox_speech",
       "seamless_communication_torch.segment.vad",
       "seamless_communication_torch.denoise.denoiser",
       "seamless_communication_torch.utils.profiling",
       "seamless_communication_torch.cli.audio_to_units",
       "seamless_communication_torch.cli.mutox_speech",
       "seamless_communication_torch.cli.mutox_text",
       "seamless_communication_torch.inference.transcriber",
       "seamless_communication_torch.streaming.agents.vad",
       "seamless_communication_torch.streaming.evaluator",
       "seamless_communication_torch.native",
       "seamless_communication_torch.cli.evaluate",
       "seamless_communication_torch.cli.eval_utils",
       "seamless_communication_torch.cli.metrics",
       "seamless_communication_torch.cli.streaming_evaluate",
       "seamless_communication_torch.cli.run_asr_bleu",
       "seamless_communication_torch.cli.etox",
       "seamless_communication_torch.cli.asr_etox",
       "seamless_communication_torch.cli.expressivity_evaluate",
       "seamless_communication_torch.cli.expressivity_pauserate",
       "seamless_communication_torch.cli.prepare_dataset",
       "seamless_communication_torch.cli.prepare_mexpresso"}
# the asset cards the port reads are its own copies
from seamless_communication_torch import assets
if assets.CARDS_DIR.resolve().parent != __import__("pathlib").Path(pkg.__path__[0]).resolve():
    bad.append(str(assets.CARDS_DIR))
print(len(names) if new <= set(names) else 0, ";".join(bad))
"""


def _run(code: str, **env) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120, env={**os.environ, **env})


def test_port_imports_no_jax():
    proc = _run(_PROBE)
    assert proc.returncode == 0, proc.stderr
    n, _, bad = proc.stdout.strip().partition(" ")
    assert int(n) >= 20
    assert bad == "", f"the port pulled in {bad}"


def test_chip_smoke_imports_no_jax():
    proc = _run("import sys, chip_smoke; print(';'.join(m for m in sys.modules "
                "if m == 'jax' or m.startswith('seamless_communication_tpu')))")
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == ""


@pytest.mark.parametrize("device", [None, "cpu"])
def test_default_device_needs_a_card(device):
    """Without a card the default device raises; ``device="cpu"`` is the
    only way onto the CPU."""
    proc = _run(
        "import torch\n"
        "from seamless_communication_torch.inference.translator import Translator\n"
        "from seamless_communication_torch.models.unity.builder import get_arch\n"
        f"dev = {device!r}\n"
        "try:\n"
        "    t = Translator({}, get_arch('tiny_v2'), None, device=dev)\n"
        "    print('device', t.device)\n"
        "except RuntimeError as e:\n"
        "    print('raised', e)\n",
        CUDA_VISIBLE_DEVICES="")
    assert proc.returncode == 0, proc.stderr
    if device is None:
        assert proc.stdout.startswith("raised no CUDA device"), proc.stdout
    else:
        assert proc.stdout.strip() == "device cpu"


@pytest.mark.parametrize("device", [None, "cpu"])
def test_streaming_default_device_needs_a_card(device):
    """The streaming pipelines too: without a card the default device raises."""
    proc = _run(
        "import torch\n"
        "from seamless_communication_torch.models.monotonic.model import (\n"
        "    MonotonicDecoderConfig, monotonic_decoder_init)\n"
        "from seamless_communication_torch.models.unity.builder import get_arch\n"
        "from seamless_communication_torch.streaming.pipeline import build_s2t_pipeline\n"
        "cfg = MonotonicDecoderConfig(model_dim=16, num_layers=1, num_heads=2,\n"
        "                             ffn_inner_dim=16, vocab_size=8,\n"
        "                             num_monotonic_energy_layers=1)\n"
        "mono = monotonic_decoder_init(torch.Generator().manual_seed(0), cfg)\n"
        "class Tok:\n"
        "    class vocab_info: eos_idx = 3\n"
        "    def lang_token(self, lang): return 4\n"
        f"dev = {device!r}\n"
        "try:\n"
        "    p = build_s2t_pipeline({}, get_arch('tiny_v2'), mono, cfg, Tok(), device=dev)\n"
        "    print('device', p.agents[1].device)\n"
        "except RuntimeError as e:\n"
        "    print('raised', e)\n",
        CUDA_VISIBLE_DEVICES="")
    assert proc.returncode == 0, proc.stderr
    if device is None:
        assert proc.stdout.startswith("raised no CUDA device"), proc.stdout
    else:
        assert proc.stdout.strip() == "device cpu"


@pytest.mark.parametrize("cli", ["audio_to_units", "mutox_speech", "mutox_text"])
def test_aux_clis_default_to_the_card(cli):
    """The auxiliary CLIs run on the card unless ``--device cpu`` is given:
    without a card and without the flag they raise before reading a file."""
    argv = {"audio_to_units": ["in.wav", "--kmeans_path", "k.npy", "--w2v2_checkpoint", "w.pt"],
            "mutox_speech": ["eng", "--classifier_pt", "m.pt"],
            "mutox_text": ["eng_Latn", "--classifier_pt", "m.pt"]}[cli]
    proc = _run(
        f"from seamless_communication_torch.cli import {cli}\n"
        "try:\n"
        f"    {cli}.main({argv!r})\n"
        "except RuntimeError as e:\n"
        "    print('raised', e)\n",
        CUDA_VISIBLE_DEVICES="")
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("raised no CUDA device"), proc.stdout


@pytest.mark.parametrize("cli", ["evaluate", "streaming_evaluate", "run_asr_bleu", "asr_etox",
                                 "expressivity_evaluate"])
def test_eval_clis_default_to_the_card(cli):
    """The evaluation CLIs run on the card unless ``--device cpu`` is given:
    without a card and without the flag they raise before reading a file."""
    argv = {"evaluate": ["data.tsv", "s2tt", "eng"],
            "streaming_evaluate": ["--data-file", "data.tsv"],
            "run_asr_bleu": ["gen", "data.tsv", "--tgt_lang", "eng"],
            "asr_etox": ["data.tsv", "out.tsv", "--lang", "eng"],
            "expressivity_evaluate": ["data.tsv", "--tgt_lang", "fra"]}[cli]
    proc = _run(
        f"from seamless_communication_torch.cli import {cli}\n"
        "try:\n"
        f"    {cli}.main({argv!r})\n"
        "except RuntimeError as e:\n"
        "    print('raised', e)\n",
        CUDA_VISIBLE_DEVICES="")
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("raised no CUDA device"), proc.stdout
