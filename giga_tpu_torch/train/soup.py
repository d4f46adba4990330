"""Greedy checkpoint soup over a pool of scored candidates (counterpart of
giga_tpu/train/soup.py).

Within a single training trajectory all checkpoints share a loss basin, so
a uniform average of several good ones is usually at least as good as the
best single step and much flatter under eval noise (Wortsman et al. 2022,
"Model soups", applied along one run instead of across runs). The reference
has no analog (train_giga.py keeps only the single best-val checkpoint,
reference train_giga.py:98-117).

Candidates are state dicts: flat or nested dicts whose leaves are tensors,
numpy arrays or numbers.
"""

from __future__ import annotations

import numpy as np


def _tree_map(fn, *trees):
    """fn over the leaves of equally shaped nested dicts."""
    if isinstance(trees[0], dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def greedy_soup(pool, score_fn, k=None, verbose=print):
    """Greedily average the top-k scored candidates.

    pool: list of (score, state_dict, tag). score_fn(state_dict) -> float.
    Starts from the best candidate; each next-best is averaged in (uniform
    weights over members) and kept only if the souped state scores at least
    as well as the current soup. Returns (score, state_dict, member_tags).
    """
    ranked = sorted(pool, key=lambda c: -c[0])
    if k is not None:
        ranked = ranked[:k]
    soup, n_in, soup_score = ranked[0][1], 1, ranked[0][0]
    members = [ranked[0][2]]
    for cand_score, cand_params, tag in ranked[1:]:
        w = 1.0 / (n_in + 1)
        cand = _tree_map(lambda a, b: (1 - w) * a + w * b, soup, cand_params)
        new_score = float(score_fn(cand))
        keep = new_score >= soup_score
        if verbose is not None:
            verbose(f"soup + {tag} ({cand_score:.1f}): {new_score:.1f} "
                    f"{'kept' if keep else 'dropped'}")
        if keep:
            soup, n_in, soup_score = cand, n_in + 1, new_score
            members.append(tag)
    return soup_score, soup, members


def uniform_average(params_list):
    """Plain uniform average of a list of state dicts (numpy or tensor
    leaves; numpy leaves come back as numpy, tensors as tensors)."""
    n = float(len(params_list))

    def mean(*xs):
        if isinstance(xs[0], np.ndarray) or np.isscalar(xs[0]):
            return sum(np.asarray(x) for x in xs) / n
        return sum(xs) / n

    return _tree_map(mean, *params_list)
