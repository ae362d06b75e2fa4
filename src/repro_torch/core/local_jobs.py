"""The seven HiBench-family algorithms as single-machine jobs (numpy/JAX) —
the profiling targets for the paper-faithful local reproduction (paper §IV:
K-Means, PageRank, Linear/Logistic Regression, Naive Bayes, Join, Sort).

Each factory takes `size_bytes` and returns a zero-arg callable whose peak
RSS the profiler measures. Working-set shape mirrors the Spark versions:
iterative ML jobs *cache* their dataset (hold it live across iterations);
Join/Sort stream with transient intermediates.

A copy of the JAX package's ``repro/core/local_jobs.py``.
"""
from __future__ import annotations

import numpy as np

_F8 = 8  # float64 bytes


def kmeans_job(size_bytes: int, d: int = 16, k: int = 8, iters: int = 8):
    n = max(64, int(size_bytes / (d * _F8)))

    def run():
        rng = np.random.default_rng(0)
        data = rng.standard_normal((n, d))          # cached dataset
        centers = data[:k].copy()
        # allocation-free iterations (||x-c||^2 = ||x||^2 - 2 x.c + ||c||^2
        # with preallocated buffers): the measured footprint is the cached
        # dataset + fixed work buffers, linear in input — as in Spark
        xsq = np.square(data).sum(1)
        d2 = np.empty((n, k))
        for _ in range(iters):
            np.matmul(data, centers.T, out=d2)
            d2 *= -2.0
            d2 += xsq[:, None]
            d2 += np.square(centers).sum(1)[None, :]
            idx = d2.argmin(1)
            for j in range(k):
                m = idx == j
                if m.any():
                    centers[j] = data[m].mean(0)
        return centers

    return run


def pagerank_job(size_bytes: int, iters: int = 8):
    m = max(256, int(size_bytes / (2 * _F8)))       # edges

    def run():
        rng = np.random.default_rng(0)
        n = max(64, m // 8)
        src = rng.integers(0, n, m)
        dst = rng.integers(0, n, m)                 # cached edge list
        rank = np.full(n, 1.0 / n)
        deg = np.maximum(np.bincount(src, minlength=n), 1)
        for _ in range(iters):
            contrib = rank[src] / deg[src]
            new = np.zeros(n)
            np.add.at(new, dst, contrib)
            rank = 0.15 / n + 0.85 * new
        return rank

    return run


def linregression_job(size_bytes: int, d: int = 32, iters: int = 6):
    n = max(64, int(size_bytes / (d * _F8)))

    def run():
        rng = np.random.default_rng(0)
        X = rng.standard_normal((n, d))
        y = X @ rng.standard_normal(d) + 0.1 * rng.standard_normal(n)
        w = np.zeros(d)
        for _ in range(iters):                      # gradient descent passes
            g = X.T @ (X @ w - y) / n
            w -= 0.1 * g
        return w

    return run


def logregression_job(size_bytes: int, d: int = 32, iters: int = 10):
    n = max(64, int(size_bytes / (d * _F8)))

    def run():
        rng = np.random.default_rng(0)
        X = rng.standard_normal((n, d))
        y = (X @ rng.standard_normal(d) > 0).astype(np.float64)
        w = np.zeros(d)
        for _ in range(iters):
            p = 1.0 / (1.0 + np.exp(-(X @ w)))
            w -= 0.5 * (X.T @ (p - y)) / n
        return w

    return run


def naivebayes_job(size_bytes: int, vocab: int = 4096, classes: int = 4):
    n = max(64, int(size_bytes / (16 * 4)))         # 16 int32 tokens per doc

    def run():
        rng = np.random.default_rng(0)
        docs = rng.integers(0, vocab, (n, 16)).astype(np.int32)
        labels = rng.integers(0, classes, n)
        counts = np.zeros((classes, vocab))
        for c in range(classes):
            np.add.at(counts[c], docs[labels == c].ravel(), 1.0)
        logp = np.log((counts + 1) / (counts.sum(1, keepdims=True) + vocab))
        return logp

    return run


def join_job(size_bytes: int):
    n = max(64, int(size_bytes / (2 * _F8)))

    def run():
        rng = np.random.default_rng(0)
        left_k = rng.integers(0, n // 2, n)
        left_v = rng.standard_normal(n)
        right_k = rng.integers(0, n // 2, n // 4)
        right_v = rng.standard_normal(n // 4)
        order = np.argsort(right_k, kind="stable")  # sort-merge join
        rk, rv = right_k[order], right_v[order]
        pos = np.searchsorted(rk, left_k)
        ok = (pos < rk.size)
        pos = np.clip(pos, 0, rk.size - 1)
        match = ok & (rk[pos] == left_k)
        return float((left_v[match] + rv[pos[match]]).sum())

    return run


def sort_job(size_bytes: int):
    n = max(64, int(size_bytes / _F8))

    def run():
        rng = np.random.default_rng(0)
        data = rng.standard_normal(n)
        return np.sort(data, kind="stable")[-1]     # terasort stand-in

    return run


LOCAL_JOBS = {
    "kmeans": kmeans_job,
    "pagerank": pagerank_job,
    "linregression": linregression_job,
    "logregression": logregression_job,
    "naivebayes": naivebayes_job,
    "join": join_job,
    "sort": sort_job,
}
