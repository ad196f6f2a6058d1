"""AlignmentExtractor: audio (or units) + text -> per-char unit durations
(counterpart of ``seamless_communication_tpu/models/aligner/extractor.py``;
reference models/aligner/alignment_extractor.py:29-150): XLSR unit
extraction -> char and unit tokenization as the alignment frontend does it
-> the aligner's forward (conv towers + Viterbi MAS). Checkpoints load
through ``checkpoint/convert_fairseq2.py`` (``aligner_tree_from_pt``,
``wav2vec2_raw_tree_from_pt``).
"""

from __future__ import annotations

from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from seamless_communication_torch.device import params_to, resolve_device
from seamless_communication_torch.models.aligner.model import AlignerConfig, aligner_forward
from seamless_communication_torch.models.unit_extractor.unit_extractor import (
    KmeansModel, UnitExtractor,
)
from seamless_communication_torch.models.unit_extractor.wav2vec2_raw import (
    Wav2Vec2RawConfig,
)
from seamless_communication_torch.models.unity.unit_tokenizer import UnitTokenizer
from seamless_communication_torch.text.char_tokenizer import CharTokenizer


class AlignmentExtractor:
    """Audio or units + text -> (durations, attention log-probs).

    The arguments are the reference's: the aligner ``.pt``, the XLSR
    encoder's ``.pt`` and the k-means ``.npy`` (unit extraction is skipped
    when units are given to :meth:`extract_alignment`). ``char_tokenizer``
    tokenizes text as the reference alignment frontend's raw char encoder
    does (reference aligner/model.py:40-52). Runs on ``device``: the CUDA
    card unless it says ``cpu``.
    """

    def __init__(self, aligner_pt: str,
                 xlsr_pt: Optional[str] = None,
                 kmeans_npy: Optional[str] = None, *,
                 output_layer: int = 35,
                 char_tokenizer: Optional[CharTokenizer] = None,
                 unit_tokenizer: Optional[UnitTokenizer] = None,
                 aligner_cfg: AlignerConfig = AlignerConfig(),
                 xlsr_cfg: Wav2Vec2RawConfig = Wav2Vec2RawConfig(),
                 device=None):
        from seamless_communication_torch.checkpoint.convert_fairseq2 import (
            aligner_tree_from_pt, load_pt_state_dict, wav2vec2_raw_tree_from_pt,
        )

        self.device = resolve_device(device)
        self.cfg = aligner_cfg
        ckpt = torch.load(aligner_pt, map_location="cpu", weights_only=True)
        self.params = params_to(aligner_tree_from_pt(ckpt), self.device)
        self.char_tokenizer = char_tokenizer
        self.unit_tokenizer = unit_tokenizer or UnitTokenizer(10000, ["eng"], "nar_v2")

        self.unit_extractor = None
        if xlsr_pt is not None:
            self.unit_extractor = UnitExtractor(
                wav2vec2_raw_tree_from_pt(load_pt_state_dict(xlsr_pt)),
                KmeansModel.from_npy(kmeans_npy), xlsr_cfg,
                out_layer_idx=output_layer - 1, device=self.device)

    # -- pieces (reference alignment_extractor.py:73-98) ---------------------

    def prepare_audio(self, audio: np.ndarray) -> np.ndarray:
        audio = np.asarray(audio, np.float32)
        if audio.ndim > 1:
            if audio.shape[0] >= audio.shape[1]:
                raise ValueError(f"expected [channel, time] audio, got {audio.shape}")
            audio = audio.mean(0)
        return audio

    def extract_units(self, audio: np.ndarray) -> List[int]:
        if self.unit_extractor is None:
            raise ValueError("a unit extractor (xlsr_pt, kmeans_npy) is needed to "
                             "derive units from audio")
        return self.unit_extractor.predict(audio[None])[0]

    def tokenize_text(self, text: str, *, add_trailing_silence: bool = False) -> List[int]:
        if self.char_tokenizer is None:
            raise ValueError("a char tokenizer is needed to tokenize text")
        ids = self.char_tokenizer.encode(text)
        if add_trailing_silence:
            ids = ids + [ids[0]]
        return ids

    # -- main entry (reference alignment_extractor.py:100-150) ---------------

    def extract_alignment(self, audio: Union[np.ndarray, List[int]], text: str, *,
                          add_trailing_silence: bool = False
                          ) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (durations (1, T_text) np.int32, attention log-probs
        (1, T_feat, T_text))."""
        if (isinstance(audio, (list, tuple))
                or (isinstance(audio, np.ndarray)
                    and np.issubdtype(np.asarray(audio).dtype, np.integer))):
            units = [int(u) for u in np.asarray(audio).reshape(-1)]
        else:
            units = self.extract_units(self.prepare_audio(audio))

        # NAR unit tokenization: raw units + 4, no language prefix
        # (reference frontend encode_unit with is_nar_decoder=True)
        unit_ids = self.unit_tokenizer.encode(np.asarray([units], np.int64), "eng")
        text_ids = np.asarray(
            [self.tokenize_text(text, add_trailing_silence=add_trailing_silence)], np.int64)
        lprob, durations = aligner_forward(
            self.params, self.cfg, text_ids, unit_ids,
            np.array([text_ids.shape[1]], np.int64), np.array([unit_ids.shape[1]], np.int64))
        return durations.astype(np.int32), lprob
