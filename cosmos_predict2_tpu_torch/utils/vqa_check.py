"""VQA-based output-quality checks for generated videos.

The port's copy of cosmos_predict2_tpu/utils/vqa_check.py. The reference
ships per-example VQA question specs under
`tests/vqa_questions/{examples,post_training}/*.yaml`: each spec is a list
of questions a vision-language model is asked about the generated clip,
with `contains` keyword lists that the VLM's answer must hit. The reference
holds only the specs (the harness runs in its external CI); this module
ships the spec schema AND an executable checker:

  spec YAML schema (reference tests/vqa_questions/examples/*.yaml):
    must_pass_checks:      # hard quality gates (blur/noise/artifacts)
      - question: ...
        answer: ...        # the expected answer, for the report
        contains: [...]    # case-insensitive keywords; >=1 must appear
    vqa_checks:            # content checks, scored
      - question: ...
        answer: ...
        contains: [...]

The answerer is pluggable: ``run_spec(spec, answer_fn)`` calls
``answer_fn(question) -> str``; no VLM is wired in (the JAX package wires
none), and tests use a deterministic stub. A clip PASSES when every
must_pass check hits and the vqa score meets ``min_vqa_score``. PyYAML is
imported inside ``load_spec``.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Callable, Sequence


@dataclasses.dataclass(frozen=True)
class VQACheck:
    question: str
    answer: str
    contains: tuple[str, ...]


@dataclasses.dataclass(frozen=True)
class VQASpec:
    must_pass_checks: tuple[VQACheck, ...]
    vqa_checks: tuple[VQACheck, ...]
    name: str = ""


def _parse_checks(items) -> tuple[VQACheck, ...]:
    out = []
    for it in items or []:
        out.append(
            VQACheck(
                question=str(it["question"]),
                answer=str(it.get("answer", "")),
                contains=tuple(str(c) for c in it.get("contains", ())),
            )
        )
    return tuple(out)


def load_spec(path: str | Path) -> VQASpec:
    try:
        import yaml
    except ImportError as e:
        raise ImportError("vqa_check.load_spec: .yaml spec files need the 'yaml' package (PyYAML), which is not "
                          "installed") from e

    path = Path(path)
    data = yaml.safe_load(path.read_text())
    return VQASpec(
        must_pass_checks=_parse_checks(data.get("must_pass_checks")),
        vqa_checks=_parse_checks(data.get("vqa_checks")),
        name=path.stem,
    )


def answer_hits(answer: str, contains: Sequence[str]) -> bool:
    """True when >=1 keyword appears in the answer (case-insensitive,
    whitespace-normalized — the reference CI's containment convention)."""
    norm = " ".join(answer.lower().split())
    return any(" ".join(kw.lower().split()) in norm for kw in contains)


@dataclasses.dataclass(frozen=True)
class VQAReport:
    name: str
    must_pass_failures: tuple[str, ...]  # questions that failed
    vqa_hits: int
    vqa_total: int
    min_vqa_score: float

    @property
    def vqa_score(self) -> float:
        return self.vqa_hits / self.vqa_total if self.vqa_total else 1.0

    @property
    def passed(self) -> bool:
        return not self.must_pass_failures and self.vqa_score >= self.min_vqa_score


def run_spec(
    spec: VQASpec,
    answer_fn: Callable[[str], str],
    min_vqa_score: float = 0.5,
) -> VQAReport:
    """Ask every question via ``answer_fn`` and score the answers."""
    failures = tuple(
        c.question for c in spec.must_pass_checks if not answer_hits(answer_fn(c.question), c.contains)
    )
    hits = sum(1 for c in spec.vqa_checks if answer_hits(answer_fn(c.question), c.contains))
    return VQAReport(
        name=spec.name,
        must_pass_failures=failures,
        vqa_hits=hits,
        vqa_total=len(spec.vqa_checks),
        min_vqa_score=min_vqa_score,
    )
