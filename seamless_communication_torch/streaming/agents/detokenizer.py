"""Detokenizer agents (counterpart of
``seamless_communication_tpu/streaming/agents/detokenizer.py``): SentencePiece
pieces to text, optionally holding back the last partial word until the next
word boundary or the end."""

from __future__ import annotations

from seamless_communication_torch.streaming.agents.common import (
    AgentStates, GenericAgent, ReadAction, TextSegment, WriteAction,
)

SPM_SPACE = "▁"


class DetokenizerAgent(GenericAgent):
    source_type = "text"
    target_type = "text"

    def __init__(self, *, detokenize_only: bool = True, args=None):
        self.detokenize_only = detokenize_only
        super().__init__(args)

    def build_states(self) -> AgentStates:
        s = AgentStates()
        s.buffer = []
        return s

    def reset(self):
        super().reset()
        self.states.buffer = []

    def policy(self, states: AgentStates):
        incoming = "".join(str(c) for c in states.source if c is not None)
        states.source = []
        pending = "".join(getattr(states, "buffer", [])) + incoming
        states.buffer = []

        if self.detokenize_only:
            words = pending.replace(SPM_SPACE, " ")
            if states.source_finished:
                return WriteAction(TextSegment(content=words), finished=True)
            if len(words) == 0:
                return ReadAction()
            return WriteAction(TextSegment(content=words), finished=False)

        if states.source_finished:
            return WriteAction(
                TextSegment(content=pending.replace(SPM_SPACE, " ").strip()),
                finished=True)
        # hold back the trailing partial word until the next ▁ arrives
        last_space = pending.rfind(SPM_SPACE)
        if last_space <= 0:
            states.buffer = [pending]
            return ReadAction()
        full = pending[:last_space].replace(SPM_SPACE, " ").strip()
        states.buffer = [pending[last_space:]]
        return WriteAction(TextSegment(content=full), finished=False)


class UnitYDetokenizerStates(AgentStates):
    """The source is the text decoder's ``UnitYTextDecoderOutput`` segments
    (the tree pipeline's text branch); only their token strings accumulate."""

    def reset(self) -> None:
        super().reset()
        self.buffer = []

    def update_source(self, segment) -> None:
        self.source_finished = segment.finished
        if self.tgt_lang is None and segment.tgt_lang is not None:
            self.tgt_lang = segment.tgt_lang
        if segment.is_empty or segment.content is None:
            return
        self.source += list(segment.content.tokens)


class UnitYDetokenizerAgent(DetokenizerAgent):
    """The tree pipeline's text branch: detokenizes the ``tokens`` of the
    output the text decoder emits for the unit branch."""

    def build_states(self) -> UnitYDetokenizerStates:
        return UnitYDetokenizerStates()
