"""Order planner: pairwise experiments → DAG → topological sort (a copy
of the reference's ``core/planner.py``; plain Python over the registry).

This is the paper's roadmap (Sec. 2): run A→B and B→A for every pair,
decide the winner by Pareto-frontier dominance of (accuracy, BitOpsCR)
samples, collect the pairwise edges into a DAG, and topologically sort it
into the combinational sequence law.  ``theoretical_order()`` returns the
sequence implied by the paper's static→dynamic / large→small-granularity
principles without running anything — the experiments in
benchmarks/pairwise_order.py validate that the empirical DAG matches it.

All of it is generic over the pass registry (core/registry.py): the
planner plans whatever key set is registered — the paper's four, the five
with low-rank 'L', or any third-party extension — with no 'DPQE'
assumption.  Passes sharing a (kind, granularity) class rank by key
(deterministic tiebreak; the theory does not order same-class passes), and
an empirical pairwise edge always overrides the tiebreak.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field

from repro_torch.core import registry


def pass_rank(key: str) -> tuple:
    """(kind, granularity, key) sort rank of a registered pass."""
    return registry.get_pass(key).rank


def theoretical_order(keys=None) -> str:
    """Static before dynamic; within static, large→small granularity.

    ``keys=None`` plans every registered pass.  Same-class passes order by
    key — deterministic, theory-agnostic (see registry docstring).
    """
    if keys is None:
        keys = registry.registered_keys()
    return ''.join(sorted(keys, key=pass_rank))


def theoretical_dag(keys=None) -> tuple:
    """The theory's order edges over ``keys`` (default: all registered).

    Returns ``((first, later), ...)`` — one edge per pass pair in
    *distinct* (kind, granularity) classes, ordered static→dynamic and
    large→small granularity.  Same-class pairs (e.g. 'L' and 'Q', both
    static/sub-neuron) get NO edge: their key tiebreak is a determinism
    convention, not a theorem, so a checker must not flag either order.
    The reference's order-dag analyzer rule lints Pipeline sequences
    against exactly these edges, reporting the violated one.
    """
    if keys is None:
        keys = registry.registered_keys()
    edges = []
    for a, b in itertools.combinations(sorted(set(keys)), 2):
        ra, rb = pass_rank(a)[:2], pass_rank(b)[:2]
        if ra < rb:
            edges.append((a, b))
        elif rb < ra:
            edges.append((b, a))
    return tuple(edges)


# ------------------------------------------------------------ frontier logic


def pareto_frontier(samples):
    """samples: [(acc, cr)] → non-dominated subset sorted by cr."""
    pts = sorted(samples, key=lambda p: (-p[1], -p[0]))
    front, best_acc = [], -1.0
    for acc, cr in pts:                      # decreasing cr
        if acc > best_acc:
            front.append((acc, cr))
            best_acc = acc
    return front[::-1]


def frontier_score(samples, cr_range=None):
    """Area under the accuracy-vs-log(CR) Pareto frontier.

    Higher = better compression/accuracy trade-off.  ``cr_range`` fixes the
    integration window so two frontiers are compared on common support.
    """
    import math
    front = pareto_frontier(samples)
    if not front:
        return 0.0
    lo, hi = cr_range or (min(c for _, c in front), max(c for _, c in front))
    lo, hi = math.log(max(lo, 1.0)), math.log(max(hi, lo + 1e-9))
    if hi <= lo:
        return max(a for a, _ in front)
    # step-wise integration: acc achievable at compression >= c
    area, prev = 0.0, lo
    # frontier sorted by increasing cr; acc decreases as cr increases
    xs = [(math.log(max(c, 1.0)), a) for a, c in front]
    xs.sort()
    for i, (x, a) in enumerate(xs):
        x2 = xs[i + 1][0] if i + 1 < len(xs) else hi
        x, x2 = max(x, lo), min(max(x2, lo), hi)
        if x2 > x:
            area += a * (x2 - x)
    return area / (hi - lo)


def compare_orders(samples_ab, samples_ba, a: str | None = None,
                   b: str | None = None):
    """Decide the winning order between two sample sets on common support.

    Exact score ties are NOT experimental evidence for either order: with
    the pass keys given, a tie falls back to the theoretical
    (kind, granularity) principle; without them it stays 'AB' for backward
    compatibility.  Callers should record tied edges with ``margin=0.0``
    (= |score difference|) so ``OrderPlanner.resolve_cycles`` drops them
    first.
    """
    crs = [c for _, c in samples_ab + samples_ba if c > 0]
    rng = (min(crs), max(crs)) if crs else None
    sa = frontier_score(samples_ab, rng)
    sb = frontier_score(samples_ba, rng)
    if sa == sb and a is not None and b is not None:
        winner = 'AB' if pass_rank(a) <= pass_rank(b) else 'BA'
        return winner, sa, sb
    return ('AB' if sa >= sb else 'BA'), sa, sb


# --------------------------------------------------------------- DAG + sort


@dataclass
class OrderPlanner:
    """Pairwise-edge collector + topological sort over a key set.

    ``keys=None`` plans all registered passes at construction time.
    """
    keys: str | None = None
    edges: set = field(default_factory=set)      # (first, later)
    margins: dict = field(default_factory=dict)  # edge -> |scoreA - scoreB|

    def __post_init__(self):
        if self.keys is None:
            self.keys = ''.join(registry.registered_keys())
        for k in self.keys:
            registry.get_pass(k)                 # fail fast on unknown keys

    def add_pairwise(self, a: str, b: str, winner: str, margin: float = 1.0):
        e = (a, b) if winner == 'AB' else (b, a)
        self.edges.add(e)
        self.margins[e] = margin

    def resolve_cycles(self):
        """Drop weakest-margin edges until acyclic (reduced-budget pairwise
        experiments can produce weak flipped edges; the paper's full-budget
        DAG is acyclic — this recovers an order while reporting what was
        dropped).  Zero-margin (tied) edges go first; equal margins break
        deterministically by edge."""
        dropped = []
        while True:
            try:
                self.topological_order()
                return dropped
            except ValueError:
                weakest = min(self.edges, key=lambda e:
                              (self.margins.get(e, 0.0), e))
                self.edges.discard(weakest)
                dropped.append(weakest)

    def pairs(self):
        return list(itertools.combinations(self.keys, 2))

    def topological_order(self) -> str:
        nodes = set(self.keys)
        edges = set(self.edges)
        indeg = {n: 0 for n in nodes}
        for _, b in edges:
            indeg[b] += 1
        order = []
        ready = [n for n in nodes if indeg[n] == 0]
        while ready:
            # the paper's hypothesis is a unique sorting; break any tie by
            # the theoretical principles (and a full pairwise sweep leaves
            # no ties anyway)
            ready.sort(key=pass_rank)
            n = ready.pop(0)
            order.append(n)
            for a, b in list(edges):
                if a == n:
                    edges.discard((a, b))
                    indeg[b] -= 1
                    if indeg[b] == 0:
                        ready.append(b)
        if len(order) != len(nodes):
            raise ValueError('pairwise results contain a cycle — the '
                             "paper's acyclicity hypothesis is violated")
        return ''.join(order)
