"""Lexically constrained beam search: fairseq's dynamic beam allocation.

Counterpart of ``s2st_tpu/generate/constrained.py`` (fairseq/search.py
LexicallyConstrainedBeamSearch, :219-528, and
token_generation_constraints.py): the constraint state machines as tensors
that ``sequence_generator.beam_search`` advances for every candidate of a
step at once.

- ``pack_constraints`` / ``unpack_constraints``: a sentence's phrases as
  one row ``[n, c1 tokens, 0, c2 tokens, 0, ...]``;
- ``build_constraint_tables``: the unordered variant's trie as tables
  (``trans`` (B, N, V) child ids, depth, depth-1 ancestor, terminal id, a
  (B, N, C) bitmap of the constraints below each node, the terminals on
  each node's root path, deepest first, and the trie's edges), or the
  ordered variant's concatenated phrases with their end flags; every
  sentence padded to the batch's widest;
- ``step_lexically_constrained``: one step's 2K candidates: the top 2K,
  each beam's best token and the tokens that advance a constraint, each
  advanced, duplicates of a (beam, token) dropped, sorted by (bank, score)
  and taken round robin across banks (fairseq's stripes);
- ``init_constraint_state`` / ``constraints_finished``.

As in JAX, each phrase is required once: duplicates in a sentence's list
collapse. The tables are the same arrays as JAX's, int64 where JAX has
int32.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

PAD, EOS = 1, 2
NEG_INF = -1e9


def pack_constraints(batch_constraints: Sequence[Sequence[Sequence[int]]]
                     ) -> np.ndarray:
    """[[c1, c2, ...] a sentence] -> packed (B, L) int32 rows
    [num_constraints, c1 tokens, 0, c2 tokens, 0, ...]."""
    maxlen = max([1] + [1 + sum(len(c) + 1 for c in sent)
                        for sent in batch_constraints])
    rows = []
    for sent in batch_constraints:
        row = [len(sent)]
        for c in sent:
            row.extend(int(t) for t in c)
            row.append(0)
        rows.append(row + [0] * (maxlen - len(row)))
    return np.asarray(rows, np.int32).reshape(len(rows), maxlen)


def unpack_constraints(row: Sequence[int]) -> List[List[int]]:
    row = [int(t) for t in row]
    out, offset = [], 1
    for _ in range(row[0]):
        end = row.index(0, offset)
        out.append(row[offset:end])
        offset = end + 1
    return out


class ConstraintTables:
    """One batch's constraint tables, on one device."""

    def __init__(self, arrays: Dict[str, torch.Tensor], representation: str,
                 num_c: int, num_edges: int, path_len: int):
        self.arrays = arrays
        self.representation = representation
        self.C = num_c          # most constraints of a sentence
        self.E = num_edges      # most trie edges of a sentence
        self.P = path_len       # most terminals on a root path

    def select(self, rows) -> "ConstraintTables":
        """The tables of the sentences ``rows`` (indices into the batch)."""
        idx = torch.as_tensor(rows, dtype=torch.long)
        return ConstraintTables(
            {k: v[idx.to(v.device)] for k, v in self.arrays.items()},
            self.representation, self.C, self.E, self.P)


def _tensors(arrays: Dict[str, np.ndarray], device) -> Dict[str,
                                                            torch.Tensor]:
    return {k: torch.from_numpy(np.ascontiguousarray(
        v.astype(bool) if v.dtype == bool else v.astype(np.int64))).to(device)
        for k, v in arrays.items()}


def build_constraint_tables(packed: np.ndarray, vocab_size: int,
                            representation: str = "unordered",
                            device="cpu") -> ConstraintTables:
    """packed (B, L) from ``pack_constraints`` -> the batch's tables,
    each sentence padded to the widest."""
    batch = [unpack_constraints(r) for r in packed]
    batch = [[list(c) for i, c in enumerate(sent)
              if c and c not in [list(x) for x in sent[:i]]]
             for sent in batch]
    b = len(batch)

    if representation == "ordered":
        seqs, ends = [], []
        for sent in batch:
            seq, end = [], []
            for c in sent:
                seq.extend(c)
                end.extend([False] * (len(c) - 1) + [True])
            seqs.append(seq)
            ends.append(end)
        m = max((len(s) for s in seqs), default=1) or 1
        seq_arr = np.zeros((b, m), np.int32)
        end_arr = np.zeros((b, m), bool)
        total = np.zeros((b,), np.int32)
        ncons = np.zeros((b,), np.int32)
        for i, (s, e) in enumerate(zip(seqs, ends)):
            seq_arr[i, :len(s)] = s
            end_arr[i, :len(e)] = e
            total[i] = len(s)
            ncons[i] = sum(e)
        arrays = dict(seq=seq_arr, endpoints=end_arr, total=total,
                      ncons=ncons)
        return ConstraintTables(_tensors(arrays, device), "ordered",
                                int(ncons.max(initial=1)), 0, 0)

    tries = []
    for sent in batch:
        # nodes: 0 = root; (parent, token, depth, terminal id, children)
        nodes = [dict(parent=-1, token=-1, depth=0, term=-1, children={})]
        for cid, c in enumerate(sent):
            cur = 0
            for tok in c:
                nxt = nodes[cur]["children"].get(tok)
                if nxt is None:
                    nxt = len(nodes)
                    nodes.append(dict(parent=cur, token=tok,
                                      depth=nodes[cur]["depth"] + 1,
                                      term=-1, children={}))
                    nodes[cur]["children"][tok] = nxt
                cur = nxt
            nodes[cur]["term"] = cid
        tries.append(nodes)

    n_nodes = max((len(t) for t in tries), default=1)
    n_c = max((len(s) for s in batch), default=1) or 1
    n_e = max((sum(len(n["children"]) for n in t) for t in tries),
              default=1) or 1
    n_p = max((max((n["depth"] for n in t), default=1) for t in tries),
              default=1) or 1

    trans = np.full((b, n_nodes, vocab_size), -1, np.int32)
    depth = np.zeros((b, n_nodes), np.int32)
    anc1 = np.zeros((b, n_nodes), np.int32)
    term = np.full((b, n_nodes), -1, np.int32)
    desc = np.zeros((b, n_nodes, n_c), bool)
    path_term = np.full((b, n_nodes, n_p), -1, np.int32)
    edge_src = np.zeros((b, n_e), np.int32)
    edge_tok = np.zeros((b, n_e), np.int32)
    edge_valid = np.zeros((b, n_e), bool)
    clen = np.zeros((b, n_c), np.int32)
    ncons = np.zeros((b,), np.int32)
    total = np.zeros((b,), np.int32)

    for i, (sent, nodes) in enumerate(zip(batch, tries)):
        ncons[i] = len(sent)
        total[i] = sum(len(c) for c in sent)
        for cid, c in enumerate(sent):
            clen[i, cid] = len(c)
        e = 0
        for nid, nd in enumerate(nodes):
            depth[i, nid] = nd["depth"]
            term[i, nid] = nd["term"]
            for tok, ch in nd["children"].items():
                trans[i, nid, tok] = ch
                edge_src[i, e], edge_tok[i, e] = nid, tok
                edge_valid[i, e] = True
                e += 1

        def collect(nid):
            s = set()
            if nodes[nid]["term"] >= 0:
                s.add(nodes[nid]["term"])
            for ch in nodes[nid]["children"].values():
                s |= collect(ch)
            for cid in s:
                desc[i, nid, cid] = True
            return s
        collect(0)
        for nid in range(len(nodes)):
            path, cur = [], nid
            while cur > 0:
                if nodes[cur]["term"] >= 0:
                    path.append(nodes[cur]["term"])
                if nodes[cur]["parent"] == 0:
                    anc1[i, nid] = cur
                cur = nodes[cur]["parent"]
            path_term[i, nid, :len(path)] = path

    arrays = dict(trans=trans, depth=depth, anc1=anc1, term=term, desc=desc,
                  path_term=path_term, edge_src=edge_src, edge_tok=edge_tok,
                  edge_valid=edge_valid, clen=clen, ncons=ncons, total=total)
    return ConstraintTables(_tensors(arrays, device), "unordered", n_c, n_e,
                            n_p)


# --------------------------------------------------------------------------
# the state machines, for (B, n) states at once
# --------------------------------------------------------------------------

def _rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, M, ...) gathered along axis 1 by idx (B, n)."""
    shape = idx.shape + x.shape[2:]
    view = idx.view(idx.shape + (1,) * (x.dim() - 2)).expand(shape)
    return torch.gather(x, 1, view)


def _advance_unordered(tb, node, met, token):
    """UnorderedConstraintState.advance: node, token (B, n), met (B, n,
    C). A constraint is still wanted below a node while fewer of its
    descendants are met (plus one if it is on the current path) than it
    has; falling off the trie completes the deepest unmet terminal on the
    old node's root path."""
    vocab = tb["trans"].shape[2]
    child = torch.gather(tb["trans"].flatten(1), 1, node * vocab + token)
    rootchild = torch.gather(tb["trans"][:, 0], 1, token)

    def generated(n, on_path):
        d = _rows(tb["desc"], n.clamp(min=0))
        num = d.sum(-1)
        return ((d & met).sum(-1) + on_path.long() < num) & (num > 0)

    child_ok = (child >= 0) & generated(child, torch.zeros_like(met[..., 0]))
    on_path = (rootchild == torch.gather(tb["anc1"], 1, node)) & (node > 0)
    root_ok = (rootchild >= 0) & generated(rootchild, on_path)

    path = _rows(tb["path_term"], node)                       # (B, n, P)
    unmet = (path >= 0) & ~torch.gather(met, 2, path.clamp(min=0))
    first = unmet.long().argmax(-1, keepdim=True)
    complete = torch.where(unmet.any(-1), torch.gather(path, 2, first)[
        ..., 0], -1)
    ids = torch.arange(met.shape[-1], device=met.device)
    met_rewind = met | ((ids == complete[..., None])
                        & (complete[..., None] >= 0))
    new_node = torch.where(child_ok, child,
                           torch.where(root_ok, rootchild, 0))
    return new_node, torch.where(child_ok[..., None], met, met_rewind)


def _state_unordered(tb, node, met):
    """(bank, finished) of (node, met), (B, n) each."""
    bank = (tb["clen"][:, None, :] * met).sum(-1) \
        + torch.gather(tb["depth"], 1, node)
    tn = torch.gather(tb["term"], 1, node)
    in_final = (tn >= 0) & ~torch.gather(met, 2, tn.clamp(min=0)[..., None])[
        ..., 0]
    finished = met.sum(-1) + in_final.long() >= tb["ncons"][:, None]
    return bank, finished


def _advance_ordered(tb, state, token):
    """OrderedConstraintState.advance; state -1 is the root, which stays
    the root on a miss (fairseq's endpoints[-1] is True)."""
    m = tb["total"][:, None]
    last = tb["seq"].shape[1] - 1
    finished = state + 1 >= m
    nxt = torch.gather(tb["seq"], 1, (state + 1).clamp(0, last))
    match = ~finished & (token == nxt)
    at_end = torch.where(state < 0, m > 0, torch.gather(
        tb["endpoints"], 1, state.clamp(0, last)))
    restart = token == tb["seq"][:, :1]
    return torch.where(finished, state, torch.where(
        match, state + 1, torch.where(at_end, state, torch.where(
            restart, 0, -1))))


def _state_ordered(tb, state, met):
    return state + 1, state + 1 >= tb["total"][:, None]


def _stable_order(key: torch.Tensor) -> torch.Tensor:
    return torch.sort(key, dim=-1, stable=True).indices


def step_lexically_constrained(tables: ConstraintTables, k: int, vocab: int,
                               lprobs: torch.Tensor,
                               alive_scores: torch.Tensor,
                               cnode: torch.Tensor, cmet: torch.Tensor
                               ) -> Tuple[torch.Tensor, ...]:
    """lprobs (B, K, V), alive_scores (B, K), cnode (B, K), cmet (B, K, C)
    -> the 2K candidates' scores, tokens, beams and new states."""
    tb = tables.arrays
    b, _, v = lprobs.shape
    dev = lprobs.device
    if tables.representation == "unordered":
        state_fn = _state_unordered
        adv_fn = lambda n, mt, tok: _advance_unordered(tb, n, mt, tok)
    else:
        state_fn = _state_ordered
        adv_fn = lambda n, mt, tok: (_advance_ordered(tb, n, tok), mt)

    # an unfinished beam may not end
    _, fin = state_fn(tb, cnode, cmet)
    cum = alive_scores[:, :, None] + lprobs
    cum[:, :, EOS] += torch.where(fin, 0.0, NEG_INF)
    cum[:, :, PAD] = NEG_INF

    # the pool: the top 2K, each beam's best token, the constraint tokens
    beam_k = torch.arange(k, device=dev)
    top_s, top_i = torch.sort(cum.reshape(b, k * v), dim=-1, descending=True,
                              stable=True)
    top_s, top_i = top_s[:, :2 * k], top_i[:, :2 * k]
    best_i = cum.argmax(-1, keepdim=True)          # the first of equal maxima
    pool_beam = [top_i // v, beam_k.expand(b, k)]
    pool_tok = [top_i % v, best_i[:, :, 0]]
    pool_score = [top_s, torch.gather(cum, 2, best_i)[:, :, 0]]
    if tables.representation == "unordered":
        src = tb["edge_src"][:, None, :]
        ok = tb["edge_valid"][:, None, :] & ((src == cnode[:, :, None])
                                             | (src == 0))
        toks = tb["edge_tok"][:, None, :].expand(b, k, -1)
    else:
        last = tb["seq"].shape[1] - 1
        nxt = torch.gather(tb["seq"], 1, (cnode + 1).clamp(0, last))
        toks = torch.stack([nxt, tb["seq"][:, :1].expand(b, k)], -1)
        ok = torch.stack([cnode + 1 < tb["total"][:, None], cnode > 0], -1)
    pool_beam.append(beam_k[None, :, None].expand(toks.shape).reshape(b, -1))
    pool_tok.append(toks.reshape(b, -1))
    pool_score.append(torch.where(ok, torch.gather(cum, 2, toks),
                                  NEG_INF).reshape(b, -1))
    beams = torch.cat(pool_beam, 1)
    toks = torch.cat(pool_tok, 1)
    scores = torch.cat(pool_score, 1)
    n = beams.shape[1]

    # advance every candidate; its bank (dead candidates: -1)
    new_node, new_met = adv_fn(torch.gather(cnode, 1, beams),
                               _rows(cmet, beams), toks)
    banks, _ = state_fn(tb, new_node, new_met)
    banks = torch.where(scores > NEG_INF / 2, banks, -1)

    # a (beam, token) pair counts once: the first in pool order
    pos = torch.arange(n, device=dev)
    earlier = pos[None, :] < pos[:, None]                    # [i, j]: j < i
    key = beams * (vocab + 1) + toks
    dup = ((key[:, None, :] == key[:, :, None]) & earlier).any(-1)
    scores = torch.where(dup, NEG_INF, scores)
    banks = torch.where(dup, -1, banks)

    # by bank, then score, both descending (stable)
    o1 = _stable_order(-scores)
    order = torch.gather(o1, 1, _stable_order(torch.gather(-banks, 1, o1)))
    scores, banks, beams, toks, new_node = (
        torch.gather(x, 1, order)
        for x in (scores, banks, beams, toks, new_node))
    new_met = _rows(new_met, order)

    # stripes: rank within the bank, round robin across banks
    rank = ((banks[:, None, :] == banks[:, :, None]) & earlier).sum(-1)
    tot = tb["total"].clamp(min=1).float()[:, None]
    stripes = (tot - banks.float()) + rank.float() * (n + 1)
    stripes = torch.where(scores > NEG_INF / 2, stripes, float("inf"))
    sel = _stable_order(stripes)[:, :2 * k]
    return (torch.gather(scores, 1, sel), torch.gather(toks, 1, sel),
            torch.gather(beams, 1, sel), torch.gather(new_node, 1, sel),
            _rows(new_met, sel))


def init_constraint_state(tables: ConstraintTables, b: int, k: int
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The root state of every beam: (node (B, K), met (B, K, C))."""
    dev = next(iter(tables.arrays.values())).device
    node0 = torch.full((b, k), -1 if tables.representation == "ordered"
                       else 0, dtype=torch.long, device=dev)
    return node0, torch.zeros((b, k, tables.C), dtype=torch.bool, device=dev)


def constraints_finished(tables: ConstraintTables, cnode: torch.Tensor,
                         cmet: torch.Tensor) -> torch.Tensor:
    """(B, K) bool: may this beam emit EOS?"""
    if tables.representation == "ordered":
        return _state_ordered(tables.arrays, cnode, cmet)[1]
    return _state_unordered(tables.arrays, cnode, cmet)[1]


__all__ = ["ConstraintTables", "build_constraint_tables", "pack_constraints",
           "unpack_constraints", "step_lexically_constrained",
           "init_constraint_state", "constraints_finished"]
