"""What decides ``correct``: served answers against the plain reference.

Which answers are compared is drawn from the seed while the window runs
(:class:`Sample`), so that the loop holds only those answers and drops
the rest at once.  Per template, the first flush group of every size
that occurs is taken, and each later group with probability
:data:`GROUP_RATE`.  Of a group taken, the first and the last answer
and two drawn at random are compared (the last catches a bucket whose
later half went wrong), answers of more than :data:`BIG_ROWS` rows up
to :data:`BIG_PER_TEMPLATE` a template, so that the check stays
shorter than the window.

Once the window has closed and the program is gone, :func:`verdict`
computes each distinct query text's answer with
:mod:`s2bench.reference` and compares every kept answer with it, exactly
(:func:`s2bench.reference.canonical`).  The numbers compared, with their
limits: ``wrong_answers`` (0), ``failed_requests`` (0: every request
submitted is answered without an error), and ``templates_checked`` (at
least the mix's template count).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Set, Tuple

import numpy as np

from s2bench import reference

GROUP_RATE = 0.125
PER_GROUP = 4
BIG_ROWS = 100_000
BIG_PER_TEMPLATE = 3
#: stream of the seed's generator that draws the sample
SAMPLE_STREAM = 3


class Sample:
    """The ``keep`` policy of :class:`s2bench.loop.ClosedLoop`."""

    def __init__(self, seed: int):
        self.rng = np.random.default_rng([seed, SAMPLE_STREAM])
        self.sizes: Set[Tuple[str, int]] = set()
        self.big: Dict[str, int] = {}

    def __call__(self, template: str, answers: List[object]) -> List[int]:
        size = len(answers)
        first = (template, size) not in self.sizes
        self.sizes.add((template, size))
        draw = self.rng.random()
        picks = [0, size - 1] + [int(i) for i in self.rng.integers(
            size, size=PER_GROUP - 2)]
        if not first and draw >= GROUP_RATE:
            return []
        chosen = []
        for i in dict.fromkeys(picks):
            if answers[i] is None:
                continue
            if len(answers[i]) > BIG_ROWS:
                if self.big.get(template, 0) >= BIG_PER_TEMPLATE:
                    continue
                self.big[template] = self.big.get(template, 0) + 1
            chosen.append(i)
        return sorted(chosen)


def verdict(requests: Sequence, store: reference.Store,
            templates: Sequence[str]) -> Dict[str, dict]:
    """The numbers compared, each with its limit and which way it holds."""
    wanted: Dict[str, tuple] = {}
    wrong, checked, seen = 0, 0, set()
    n_terms = len(store.terms)
    for r in requests:
        if r.result is None:
            continue
        if r.qtext not in wanted:
            ans = store.answer(r.qtext)
            wanted[r.qtext] = reference.canonical(ans.vars, ans.data, n_terms)
        got = reference.canonical(r.result.cols, r.result.data, n_terms)
        checked += 1
        seen.add(r.template)
        if not reference.same_answer(got, wanted[r.qtext]):
            wrong += 1
    failed = sum(1 for r in requests if r.error is not None)
    return {
        "wrong_answers": {"value": wrong, "limit": 0, "holds": "<="},
        "failed_requests": {"value": failed, "limit": 0, "holds": "<="},
        "templates_checked": {"value": len(seen), "limit": len(templates),
                              "holds": ">="},
        "answers_checked": {"value": checked, "limit": len(templates),
                            "holds": ">="},
    }


def passes(numbers: Dict[str, dict]) -> bool:
    return all(n["value"] <= n["limit"] if n["holds"] == "<="
               else n["value"] >= n["limit"] for n in numbers.values())
