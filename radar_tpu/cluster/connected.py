"""Connected-component labeling for detection clustering (SURVEY.md L6).

The reference implements BFS flood fill three times (intra-beam
fun_process_single_frame.m:302-352, inter-beam :355-407, inter-frame
main_simulate_echoes_with_array_v8_3.m:253-335). Connected components are
order-independent, so the array formulation replaces BFS with masked min-label
propagation plus pointer jumping over the gate-adjacency matrix: fixed
[cap, cap] shapes, a lax.while_loop to fixpoint — no data-dependent
Python control flow (SURVEY.md section 7.4 "Irregular algorithms").

A cluster's label is the smallest member index; merge helpers reduce fields
per label with either power-weighted means (stage 1, ref :339-351) or
winner-take-all by power (stage 2, ref :392-406).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def connected_labels(adj: jnp.ndarray, valid: jnp.ndarray) -> jnp.ndarray:
    """Labels [n] int32: smallest member index of each component; invalid
    slots get label n. ``adj`` need not include self-edges or be masked.

    Min-propagation + pointer-jumping iterated TO FIXPOINT with a
    lax.while_loop. The previous fixed trip count (ceil(log2 n)+2) was
    based on a doubling argument that does not hold — the jump adopts
    the current-best node's label, which need not be farther along the
    victim's path, so worst-case convergence is O(n) steps and
    chain-shaped clusters in adversarial slot order were left
    under-merged (one physical cluster labeled as 2+; CONFIRMED on a
    7-node chain in slot order [1,4,2,3,6,5,0] — round-5 self-review).
    The while condition costs one [n] compare per step; typical graphs
    still converge in O(log n) steps."""
    n = adj.shape[0]
    idx = jnp.arange(n, dtype=jnp.int32)
    vmask = valid[None, :] & valid[:, None]
    a = (adj & vmask) | (jnp.eye(n, dtype=bool) & valid[None, :])
    init = jnp.where(valid, idx, n).astype(jnp.int32)

    def step(labels):
        nb = jnp.where(a, labels[None, :], n)
        new = jnp.minimum(labels, jnp.min(nb, axis=1)).astype(jnp.int32)
        # pointer jumping: adopt your current representative's label
        jumped = jnp.where(new < n, new, 0)
        new = jnp.minimum(new, jnp.where(new < n, new[jumped], n))
        return new.astype(jnp.int32)

    def body(state):
        labels, _ = state
        new = step(labels)
        return new, jnp.any(new != labels)

    labels, _ = jax.lax.while_loop(lambda s: s[1], body,
                                   (init, jnp.bool_(True)))
    return labels


def gate_adjacency(fields: list[tuple[jnp.ndarray, float]],
                   valid: jnp.ndarray) -> jnp.ndarray:
    """Adjacency from per-field absolute-difference gates: A[i,j] = all_k
    |f_k[i] - f_k[j]| <= gate_k (the reference's clustering criterion).
    Invalid slots are masked out (their zero-filled fields would
    otherwise gate as mutually adjacent near the origin)."""
    n = valid.shape[0]
    a = valid[None, :] & valid[:, None]
    for f, gate in fields:
        a = a & (jnp.abs(f[:, None] - f[None, :]) <= gate)
    return a


def merge_weighted_mean(labels: jnp.ndarray, valid: jnp.ndarray,
                        power: jnp.ndarray,
                        fields: dict[str, jnp.ndarray]):
    """Per-component power-weighted means (stage-1 merge, ref :339-351).

    Returns (merged fields dict, total_power [n], rep_valid [n]): outputs
    live at each component's representative slot (label == own index)."""
    n = labels.shape[0]
    idx = jnp.arange(n, dtype=jnp.int32)
    member = (labels[None, :] == idx[:, None]) & valid[None, :]  # [n, n]
    memberf = member.astype(power.dtype)
    wsum = memberf @ power
    safe = jnp.where(wsum > 0, wsum, 1.0)
    merged = {k: (memberf @ (v * power)) / safe for k, v in fields.items()}
    rep_valid = valid & (labels == idx)
    return merged, wsum, rep_valid


def merge_winner_take_all(labels: jnp.ndarray, valid: jnp.ndarray,
                          power: jnp.ndarray,
                          fields: dict[str, jnp.ndarray]):
    """Per-component winner-take-all by power (stage-2 merge, ref :392-406).

    Returns (winner fields dict incl. power, rep_valid [n])."""
    n = labels.shape[0]
    idx = jnp.arange(n, dtype=jnp.int32)
    member = (labels[None, :] == idx[:, None]) & valid[None, :]
    neg_inf = jnp.asarray(-jnp.inf, power.dtype)
    scores = jnp.where(member, power[None, :], neg_inf)
    winner = jnp.argmax(scores, axis=1)
    merged = {k: v[winner] for k, v in fields.items()}
    merged["power"] = power[winner]
    rep_valid = valid & (labels == idx)
    return merged, rep_valid


def connected_components_np(adj: np.ndarray) -> np.ndarray:
    """Host-side BFS connected components (for variable-length cumulative
    logs, e.g. inter-frame track association). Returns 0-based component ids
    in first-seen order — the same ids the reference's BFS assigns."""
    n = adj.shape[0]
    comp = -np.ones(n, dtype=np.int64)
    next_id = 0
    for i in range(n):
        if comp[i] >= 0:
            continue
        stack = [i]
        comp[i] = next_id
        while stack:
            u = stack.pop()
            for v in np.nonzero(adj[u] & (comp < 0))[0]:
                comp[v] = next_id
                stack.append(v)
        next_id += 1
    return comp
