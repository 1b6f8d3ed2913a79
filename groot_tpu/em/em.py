"""Expectation-Maximization over graph equivalence classes.

Reference: /root/reference/src/em/em.go (plain EM, no SQUAREM) driven by
GrootGraph.RunEM/ProcessEMpaths (/root/reference/src/graph/paths.go:32-98):
equivalence classes are graph nodes; each ec's member set is the node's
path IDs and its count is KmerFreq / len(sequence).

Batched form: the per-ec loops become two matmuls per iteration over a
dense membership matrix M [E, P]:

    denom      = M @ alpha                      (masked where count==0 or
                                                 denom < tolerance)
    next_alpha = alpha * (M^T @ (count/denom))

run under jax.lax.while_loop with the reference's convergence rule
(no path with alpha > 1e-2 changing by > 1% after min_iterations, then one
final round after zeroing alphas < 1e-8; em.go:60-150). The products run
at HIGHEST precision: a float32 matmul may otherwise run in TF32 on a GPU.
``run_em_batched_np`` is the float64 NumPy reference of the batched loop.
"""

from __future__ import annotations

from functools import partial
from typing import Dict, List, Tuple

import jax
import jax.numpy as jnp
import numpy as np

TOLERANCE = np.nextafter(1.0, 2.0) - 1.0  # em.go:11
ALPHA_LIMIT = 1e-7
ALPHA_CHANGE = 1e-2
ALPHA_CHANGE_LIMIT = 1e-2
HIGHEST = jax.lax.Precision.HIGHEST


@partial(jax.jit, static_argnames=("min_iterations", "max_iterations"))
def _run_em(membership, counts, min_iterations: int, max_iterations: int):
    E, P = membership.shape
    m = membership.astype(jnp.float32)
    counts = counts.astype(jnp.float32)
    alpha0 = jnp.full((P,), 1.0 / P, dtype=jnp.float32)

    def update(alpha):
        denom = jnp.matmul(m, alpha, precision=HIGHEST)  # [E]
        valid = (counts != 0) & (denom >= TOLERANCE)
        count_norm = jnp.where(valid, counts / jnp.maximum(denom, TOLERANCE), 0.0)
        return alpha * jnp.matmul(count_norm, m, precision=HIGHEST)  # [P]

    def body(state):
        it, alpha, alpha_b4, final_round, done = state
        next_alpha = update(alpha)
        changed = (next_alpha > ALPHA_CHANGE_LIMIT) & (
            jnp.abs(next_alpha - alpha) / jnp.maximum(next_alpha, 1e-30)
            > ALPHA_CHANGE
        )
        stop = (~changed.any()) & (it > min_iterations)
        # if this was the final round, we are done (em.go:125-127)
        done = final_round
        # entering the final round: save pre-zero alphas, zero tiny ones
        enter_final = stop & (~final_round)
        alpha_b4 = jnp.where(enter_final, next_alpha, alpha_b4)
        next_alpha = jnp.where(
            enter_final & (next_alpha < ALPHA_LIMIT / 10.0), 0.0, next_alpha
        )
        return (it + 1, next_alpha, alpha_b4, final_round | enter_final, done)

    def cond(state):
        it, _, _, _, done = state
        return (~done) & (it < max_iterations)

    init = (
        jnp.array(0),
        alpha0,
        alpha0,
        jnp.array(False),
        jnp.array(False),
    )
    it, alpha, alpha_b4, final_round, done = jax.lax.while_loop(cond, body, init)
    # if we hit max_iterations without converging, keep alphas as-is
    alpha_b4 = jnp.where(done, alpha_b4, alpha)
    return it, alpha, alpha_b4


class EMRunner:
    """NewEM/Run/Return equivalent (em.go:29-158)."""

    def __init__(
        self,
        num_iterations: int,
        min_iterations: int,
        paths: Dict[int, str],
        lengths: Dict[int, int],
        ec_map: Dict[int, List[int]],
        counts: Dict[int, float],
    ):
        if num_iterations < min_iterations:
            raise ValueError(
                f"number of EM iterations ({num_iterations}) must be greater "
                f"than minimum iterations ({min_iterations})"
            )
        self.path_ids = sorted(paths)
        self.dense = {p: i for i, p in enumerate(self.path_ids)}
        P = len(self.path_ids)
        ecs = sorted(ec_map)
        E = len(ecs)
        self.membership = np.zeros((E, P), dtype=np.float32)
        self.counts = np.zeros(E, dtype=np.float32)
        for e, ec in enumerate(ecs):
            for pid in ec_map[ec]:
                self.membership[e, self.dense[pid]] = 1.0
            self.counts[e] = counts[ec]
        self.num_iterations = num_iterations
        self.min_iterations = min_iterations
        self.iterations_ran = 0
        self.alpha: np.ndarray | None = None

    def run(self) -> None:
        it, alpha, _alpha_b4 = _run_em(
            jnp.asarray(self.membership),
            jnp.asarray(self.counts),
            self.min_iterations,
            self.num_iterations,
        )
        self.iterations_ran = int(it)
        self.alpha = np.asarray(alpha, dtype=np.float64)

    def result(self) -> Tuple[int, Dict[int, float]]:
        if self.iterations_ran < 1:
            raise RuntimeError("no EM iterations were ran")
        return self.iterations_ran, {
            pid: float(self.alpha[i]) for i, pid in enumerate(self.path_ids)
        }


def run_em_on_graph(graph, min_iterations: int, num_iterations: int) -> None:
    """GrootGraph.RunEM (paths.go:32-69)."""
    ec_map: Dict[int, List[int]] = {}
    counts: Dict[int, float] = {}
    for node in graph.sorted_nodes:
        if node.marked:
            continue
        if node.segment_id in ec_map:
            raise ValueError("duplicate node ID found in graph")
        ec_map[node.segment_id] = list(node.path_ids)
        counts[node.segment_id] = node.kmer_freq / len(node.sequence)
    em = EMRunner(
        num_iterations,
        min_iterations,
        graph.paths,
        graph.lengths,
        ec_map,
        counts,
    )
    em.run()
    graph.em_iterations, alpha = em.result()
    graph.alpha = alpha


@partial(jax.jit, static_argnames=("min_iterations", "max_iterations"))
def _run_em_batched(
    membership, counts, n_paths, min_iterations: int, max_iterations: int
):
    """The EM loop over a padded [G, E, P] graph batch in ONE jit call
    (SURVEY §2.3 'batched EM across graphs'): pad rows carry count 0 (never
    contribute) and pad path lanes start at alpha 0 (multiplicative updates
    keep them 0). Each graph lane keeps the scalar loop's exact flag dance
    (final round, alpha_b4) by freezing its state once done — the batch
    loop runs until the slowest graph finishes."""
    G, E, P = membership.shape
    m = membership.astype(jnp.float32)
    counts = counts.astype(jnp.float32)
    lanes = jnp.arange(P)
    np_f = jnp.maximum(n_paths.astype(jnp.float32), 1.0)
    alpha0 = jnp.where(lanes[None, :] < n_paths[:, None], 1.0 / np_f[:, None], 0.0)

    def update(alpha):
        denom = jnp.einsum("gep,gp->ge", m, alpha, precision=HIGHEST)
        valid = (counts != 0) & (denom >= TOLERANCE)
        cn = jnp.where(valid, counts / jnp.maximum(denom, TOLERANCE), 0.0)
        return alpha * jnp.einsum("ge,gep->gp", cn, m, precision=HIGHEST)

    def body(state):
        it, alpha, alpha_b4, final_round, done = state
        na = update(alpha)
        changed = (
            (na > ALPHA_CHANGE_LIMIT)
            & (
                jnp.abs(na - alpha) / jnp.maximum(na, 1e-30)
                > ALPHA_CHANGE
            )
        ).any(axis=1)
        stop = (~changed) & (it > min_iterations)
        new_done = done | final_round  # lanes that just ran their final round
        enter_final = stop & ~final_round & ~done
        alpha_b4 = jnp.where(enter_final[:, None], na, alpha_b4)
        na = jnp.where(
            enter_final[:, None] & (na < ALPHA_LIMIT / 10.0), 0.0, na
        )
        na = jnp.where(done[:, None], alpha, na)  # frozen lanes don't move
        it = it + (~done).astype(jnp.int32)
        return (it, na, alpha_b4, final_round | enter_final, new_done)

    def cond(state):
        it, _, _, _, done = state
        return ((~done) & (it < max_iterations)).any()

    init = (
        jnp.zeros(G, dtype=jnp.int32),
        alpha0,
        alpha0,
        jnp.zeros(G, dtype=bool),
        jnp.zeros(G, dtype=bool),
    )
    it, alpha, alpha_b4, final_round, done = jax.lax.while_loop(
        cond, body, init
    )
    alpha_b4 = jnp.where(done[:, None], alpha_b4, alpha)
    return it, alpha, alpha_b4


def run_em_batched_np(membership, counts, n_paths, min_iterations: int,
                      max_iterations: int):
    """float64 NumPy reference of _run_em_batched: the same update rule and
    per-graph convergence flags, one graph lane at a time. Returns
    (iterations [G], alpha [G, P])."""
    membership = np.asarray(membership, np.float64)
    counts = np.asarray(counts, np.float64)
    G, E, P = membership.shape
    its = np.zeros(G, np.int64)
    out = np.zeros((G, P), np.float64)
    for g in range(G):
        m, c, n = membership[g], counts[g], int(n_paths[g])
        alpha = np.where(np.arange(P) < n, 1.0 / max(n, 1), 0.0)
        it, final_round = 0, False
        while it < max_iterations:
            denom = m @ alpha
            valid = (c != 0) & (denom >= TOLERANCE)
            cn = np.where(valid, c / np.maximum(denom, TOLERANCE), 0.0)
            na = alpha * (cn @ m)
            it += 1
            if final_round:
                alpha = na
                break
            changed = (
                (na > ALPHA_CHANGE_LIMIT)
                & (np.abs(na - alpha) / np.maximum(na, 1e-30) > ALPHA_CHANGE)
            ).any()
            if not changed and it - 1 > min_iterations:
                final_round = True
                na = np.where(na < ALPHA_LIMIT / 10.0, 0.0, na)
            alpha = na
        its[g], out[g] = it, alpha
    return its, out


def em_inputs(graphs):
    """Padded batched-EM inputs over `graphs`: (membership f32 [G, E, P],
    counts f32 [G, E], n_paths i32 [G], per-graph sorted path ids)."""
    metas = []
    for graph in graphs:
        ec_nodes = []
        seen = set()
        for node in graph.sorted_nodes:
            if node.marked:
                continue
            if node.segment_id in seen:
                raise ValueError("duplicate node ID found in graph")
            seen.add(node.segment_id)
            ec_nodes.append(node)
        path_ids = sorted(graph.paths)
        metas.append((graph, ec_nodes, path_ids))
    G = len(metas)
    E = max(len(e) for _, e, _ in metas)
    P = max(len(p) for _, _, p in metas)
    membership = np.zeros((G, E, P), dtype=np.float32)
    counts = np.zeros((G, E), dtype=np.float32)
    n_paths = np.zeros(G, dtype=np.int32)
    for g, (graph, ec_nodes, path_ids) in enumerate(metas):
        dense = {p: i for i, p in enumerate(path_ids)}
        n_paths[g] = len(path_ids)
        for e, node in enumerate(ec_nodes):
            for pid in node.path_ids:
                membership[g, e, dense[pid]] = 1.0
            counts[g, e] = node.kmer_freq / len(node.sequence)
    return membership, counts, n_paths, [p for _, _, p in metas]


def run_em_on_graphs(graphs, min_iterations: int, num_iterations: int) -> None:
    """RunEM over many graphs as one padded jit call; equivalent to
    run_em_on_graph per graph (the reference runs one goroutine per graph,
    haplotype.go:95-119 — here the graph axis is a batch dimension)."""
    if num_iterations < min_iterations:
        raise ValueError(
            f"number of EM iterations ({num_iterations}) must be greater "
            f"than minimum iterations ({min_iterations})"
        )
    if not graphs:
        return
    membership, counts, n_paths, path_lists = em_inputs(graphs)
    it, alpha, _alpha_b4 = _run_em_batched(
        jnp.asarray(membership),
        jnp.asarray(counts),
        jnp.asarray(n_paths),
        min_iterations,
        num_iterations,
    )
    it = np.asarray(it)
    alpha = np.asarray(alpha, dtype=np.float64)
    for g, (graph, path_ids) in enumerate(zip(graphs, path_lists)):
        graph.em_iterations = int(it[g])
        graph.alpha = {
            pid: float(alpha[g, i]) for i, pid in enumerate(path_ids)
        }


def process_em_paths(graph, cutoff: float, total_kmers: int) -> None:
    """GrootGraph.ProcessEMpaths (paths.go:72-98): normalise alpha -> rho,
    abundance = rho * KmerTotal / totalKmers, drop paths below cutoff."""
    if graph.em_iterations == 0:
        raise RuntimeError("EM has not been run for this graph")
    total = sum(graph.alpha.values())
    graph.abundances = {}
    for pid, a in graph.alpha.items():
        rho = a / total if total > 0 else 0.0
        kmer_share = rho * float(graph.kmer_total) / float(total_kmers)
        if kmer_share >= cutoff:
            graph.abundances[pid] = kmer_share
        else:
            graph.paths.pop(pid, None)
