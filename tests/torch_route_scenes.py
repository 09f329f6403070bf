"""One sequence's attention served three ways, for the route-invariance
tests (tests/test_torch_route_invariance.py on the CPU, tests/test_torch_gpu.py
on the card).

A scene draws, from a seed, a query for every (query head, position) and a
key and value row for every (kv head, position) of one sequence of S
tokens, and lays them out as each attention entry point reads them:

* flash (K5): the whole sequence, contiguous, causal;
* chunk (K2): positions [0, start) in pool pages through a shuffled block
  table, the chunk [start, start + C) as its own keys;
* decode (K1): one sequence per chunk position p, its prefix [0, plen) in
  the same pages (plen a page boundary a few tokens before p) and the
  positions [plen, p] in the dense tail at ``tail_pos = plen + t``.

Every route then sees the same keys at the same positions, so a row of any
of them must equal the same (head, position) row of the others.  With
``eye`` the value row of position p is the unit vector of column p % D, so
a row's output column holds the softmax weight of one key.
"""
import numpy as np
import torch


def scene(S, start, C, G, D, *, KV=2, page=4, seed=0, dtype=torch.float32, device="cpu",
          eye=False):
    rng = np.random.default_rng(seed)
    H = KV * G
    t = lambda a: torch.tensor(np.asarray(a, np.float32), dtype=dtype, device=device)
    i32 = lambda a: torch.tensor(np.asarray(a, np.int32), device=device)
    q_all = rng.normal(size=(H, S, D))
    k_all, v_all = rng.normal(size=(KV, S, D)), rng.normal(size=(KV, S, D))
    if eye:
        v_all = np.zeros((KV, S, D))
        v_all[:, np.arange(S), np.arange(S) % D] = 1.0
    n_pages = -(-S // page)
    N = n_pages + 3
    perm = rng.permutation(N)[:n_pages]  # logical page j lives in pool page perm[j]
    k_pages, v_pages = np.zeros((KV, N, page, D)), np.zeros((KV, N, page, D))
    for j, pid in enumerate(perm):
        n = min(page, S - j * page)
        k_pages[:, pid, :n] = k_all[:, j * page : j * page + n]
        v_pages[:, pid, :n] = v_all[:, j * page : j * page + n]
    bt = perm[None].astype(np.int32)
    qh = q_all.reshape(KV, G, S, D)
    flash = dict(args=[t(q_all[None]), t(k_all[None]), t(v_all[None])])
    chunk = dict(args=[
        t(qh[None, :, :, start : start + C]), t(k_pages), t(v_pages), i32(bt), i32([start]),
        t(k_all[None, :, start : start + C]), t(v_all[None, :, start : start + C])])
    pos = np.arange(start, start + C)
    plens = np.maximum(0, (pos - 5) // page * page)
    T = int((pos - plens).max()) + 1
    tail_pos = np.full((C, T), -1, np.int32)
    k_tail, v_tail = np.zeros((C, KV, T, D)), np.zeros((C, KV, T, D))
    for b, (p, plen) in enumerate(zip(pos, plens)):
        n = p - plen + 1
        tail_pos[b, :n] = plen + np.arange(n)
        k_tail[b, :, :n] = k_all[:, plen : p + 1]
        v_tail[b, :, :n] = v_all[:, plen : p + 1]
    decode = dict(args=[
        t(np.moveaxis(qh[:, :, pos], 2, 0)), t(k_pages), t(v_pages), i32(np.repeat(bt, C, 0)),
        i32(plens), t(k_tail), t(v_tail), i32(tail_pos), i32(pos)])
    return dict(flash=flash, chunk=chunk, decode=decode, start=start, C=C, KV=KV, G=G, D=D)


def rows(sc, flash_out, chunk_out, decode_out):
    """The chunk's rows from each route as [KV, G, C, D]: flash [1, H, S, D],
    chunk [1, KV, G, C, D], decode [C, KV, G, D]."""
    KV, G, C, s = sc["KV"], sc["G"], sc["C"], sc["start"]
    f = flash_out[0].reshape(KV, G, -1, flash_out.shape[-1])[:, :, s : s + C]
    return f, chunk_out[0], decode_out.permute(1, 2, 0, 3)


def off_position(kernel, dtype=torch.float32, device="cpu", seed=41):
    """(args, kwargs) whose keys the position splits cannot hold.  K1:
    decode rows with tail slots off ``prefix_len + t`` (a gap, a slot below
    the prefix at a position the pages hold too, an empty slot) and a
    prefix_len past the table's P * page (every tail slot then takes the
    extra splits).  K2: chunks after a prefix_len inside and past the
    table."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.tensor(np.asarray(a, np.float32), dtype=dtype, device=device)
    i32 = lambda a: torch.tensor(np.asarray(a, np.int32), device=device)
    KV, G, D, page, P, N = 2, 2, 16, 4, 3, 12
    pages = [t(rng.normal(size=(KV, N, page, D))) for _ in range(2)]
    if kernel == "K1":
        B, T = 3, 6
        tail_pos = [[7, 5, 6, -1, 12, 9], [9, 3, 10, 11, -1, -1], [14, 15, 16, 17, 18, 19]]
        args = [t(rng.normal(size=(B, KV, G, D))), *pages,
                i32(rng.permutation(N)[: B * P].reshape(B, P)), i32([5, 9, 14]),
                t(rng.normal(size=(B, KV, T, D))), t(rng.normal(size=(B, KV, T, D))),
                i32(tail_pos), i32([12, 11, 19])]
        return args, dict(window=9, softcap=20.0)
    B, C = 2, 8
    args = [t(rng.normal(size=(B, KV, G, C, D))), *pages,
            i32(rng.permutation(N)[: B * P].reshape(B, P)), i32([7, 15]),
            t(rng.normal(size=(B, KV, C, D))), t(rng.normal(size=(B, KV, C, D)))]
    return args, dict(window=10, softcap=20.0)
