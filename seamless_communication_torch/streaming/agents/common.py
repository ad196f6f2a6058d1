"""The streaming agents' core (counterpart of
``seamless_communication_tpu/streaming/agents/common.py``): the segments,
actions, agent states and agent pipelines of the SimulEval interface the
SeamlessStreaming agents are written against (no ``simuleval`` package is
needed). The JAX package's ``host_prefetch`` (a device-to-host copy hint for
a remotely attached TPU) has no counterpart: the agents read what they need
from the card when they need it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Optional


@dataclass
class Segment:
    content: Any = None
    finished: bool = False
    tgt_lang: Optional[str] = None
    is_empty: bool = False

    @property
    def data_type(self):
        return type(self).__name__


@dataclass
class EmptySegment(Segment):
    is_empty: bool = True


@dataclass
class SpeechSegment(Segment):
    sample_rate: int = 16000


@dataclass
class TextSegment(Segment):
    pass


class ReadAction:
    pass


class WriteAction:
    def __init__(self, content: Any, finished: bool = False):
        self.content = content
        self.finished = finished


class AgentStates:
    """An agent's streaming state: the source received so far and whether the
    source and the target have finished. It does not accumulate the target."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.source: list = []
        self.source_finished = False
        self.target_finished = False
        self.tgt_lang: Optional[str] = None

    def update_source(self, segment: Segment) -> None:
        self.source_finished = segment.finished
        if self.tgt_lang is None and segment.tgt_lang is not None:
            self.tgt_lang = segment.tgt_lang
        if not segment.is_empty:
            self.source.append(segment.content)

    def update_target(self, segment: Segment) -> None:
        self.target_finished = segment.finished


class GenericAgent:
    source_type: str = "speech"
    target_type: str = "speech"

    def __init__(self, args=None):
        self.args = args
        self.states = self.build_states()

    def build_states(self) -> AgentStates:
        return AgentStates()

    def reset(self) -> None:
        self.states.reset()

    def policy(self, states: AgentStates):
        raise NotImplementedError

    def push(self, segment: Segment) -> None:
        self.states.update_source(segment)

    def pop(self) -> Segment:
        action = self.policy(self.states)
        if isinstance(action, ReadAction):
            return EmptySegment(finished=self.states.target_finished)
        seg = action.content if isinstance(action.content, Segment) else Segment(
            content=action.content, finished=action.finished,
            tgt_lang=self.states.tgt_lang)
        seg.finished = action.finished
        self.states.update_target(seg)
        return seg


class AgentPipeline:
    """A chain of agents: each segment is pushed through every agent in turn.
    A finished output while the source is still live (an early EOS) resets
    the whole pipeline and clears the finished flag, as the reference's
    UnitY pipeline does."""

    def __init__(self, agents: List[GenericAgent]):
        self.agents = agents

    def reset(self) -> None:
        for a in self.agents:
            a.reset()

    @property
    def finished(self) -> bool:
        return self.agents[-1].states.target_finished

    def process(self, segment: Segment) -> List[Segment]:
        """Feed one source segment; return the output segments produced."""
        outputs: List[Segment] = []
        seg = segment
        for agent in self.agents:
            agent.push(seg)
            seg = agent.pop()
            if seg.is_empty and not seg.finished:
                return outputs
        if seg.finished and not self.agents[0].states.source_finished:
            self.reset()
            seg.finished = False
        if not seg.is_empty or seg.finished:
            outputs.append(seg)
        return outputs


class TreeAgentPipeline:
    """A tree of agents (the joint S2TT + S2ST streaming variants): one
    agent's output fans out to parallel branches, e.g. the EMMA text decoder
    feeds both a detokenizer (text) and the NAR unit decoder -> vocoder
    (speech), so one session emits text and waveform together.

    ``tree`` maps each agent to its children; exactly one agent is nobody's
    child, the source. ``process`` pushes one source segment, advances each
    branch (a subtree whose parent produced an empty unfinished segment is
    skipped, the linear pipeline's gate) and returns the leaves' segments of
    this cycle, each with a ``source_agent`` attribute. A finished leaf
    output while the source is still live resets the tree and clears the
    finished flags."""

    def __init__(self, tree):
        self.tree = dict(tree)
        children = [c for cs in self.tree.values() for c in cs]
        for c in children:
            self.tree.setdefault(c, [])
        if len(set(map(id, children))) != len(children):
            raise ValueError("an agent appears as a child of two parents")
        child_ids = set(map(id, children))
        roots = [a for a in self.tree if id(a) not in child_ids]
        if len(roots) != 1:
            raise ValueError(f"tree must have exactly one source, got {len(roots)}")
        self.source = roots[0]
        self.agents = list(self.tree)
        self.leaves = [a for a, cs in self.tree.items() if not cs]

    def reset(self) -> None:
        for a in self.agents:
            a.reset()

    @property
    def finished(self) -> bool:
        return all(a.states.target_finished for a in self.leaves)

    def process(self, segment: Segment) -> List[Segment]:
        outputs: List[Segment] = []

        def visit(agent: GenericAgent, seg: Segment) -> None:
            agent.push(seg)
            out = agent.pop()
            kids = self.tree[agent]
            if not kids:
                if not out.is_empty or out.finished:
                    out.source_agent = agent
                    outputs.append(out)
                return
            if out.is_empty and not out.finished:
                return
            for c in kids:
                visit(c, out)

        visit(self.source, segment)
        if (any(o.finished for o in outputs)
                and not self.source.states.source_finished):
            self.reset()
            for o in outputs:
                o.finished = False
        return outputs
