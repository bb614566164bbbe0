"""Text utilities: a vocabulary and token embeddings (counterpart of
``mxnet_tpu/contrib/text.py``; reference:
python/mxnet/contrib/text/{vocab,embedding,utils}.py).

The vocabulary is an index built once from a counter; an embedding is
one dense (V, D) NDArray assembled at load on the current context (the
card unless the caller asks for the CPU), so a lookup is one ``take``
there. Embedding files are read from local paths only.
"""
from __future__ import annotations

import collections
import re

import numpy as np

from ..base import MXNetError
from .. import ndarray as nd

__all__ = ["count_tokens_from_str", "Vocabulary", "TokenEmbedding",
           "CustomEmbedding"]


def count_tokens_from_str(source_str, token_delim=" ", seq_delim="\n",
                          to_lower=False, counter_to_update=None):
    """Token counter over a delimited string (reference:
    contrib/text/utils.py:31)."""
    source = source_str.lower() if to_lower else source_str
    tokens = [t for t in re.split(
        "[%s%s]" % (re.escape(token_delim), re.escape(seq_delim)),
        source) if t]
    counter = counter_to_update if counter_to_update is not None \
        else collections.Counter()
    counter.update(tokens)
    return counter


class Vocabulary:
    """Token <-> index mapping ordered by frequency (reference:
    contrib/text/vocab.py:33). Index 0 is the unknown token; the
    reserved tokens follow, then the counted tokens by (count desc,
    token asc)."""

    def __init__(self, counter=None, most_freq_count=None, min_freq=1,
                 unknown_token="<unk>", reserved_tokens=None):
        if min_freq < 1:
            raise MXNetError("min_freq must be >= 1")
        reserved_tokens = list(reserved_tokens or [])
        if len(set(reserved_tokens)) != len(reserved_tokens) or \
                unknown_token in reserved_tokens:
            raise MXNetError(
                "reserved tokens must be unique and exclude the "
                "unknown token")
        self._unknown_token = unknown_token
        self._reserved_tokens = reserved_tokens
        self._idx_to_token = [unknown_token] + reserved_tokens
        if counter is not None:
            ordered = sorted(counter.items(),
                             key=lambda kv: (-kv[1], kv[0]))
            if most_freq_count is not None:
                ordered = ordered[:most_freq_count]
            for token, freq in ordered:
                if freq < min_freq or token == unknown_token \
                        or token in reserved_tokens:
                    continue
                self._idx_to_token.append(token)
        self._token_to_idx = {t: i
                              for i, t in enumerate(self._idx_to_token)}

    def __len__(self):
        return len(self._idx_to_token)

    @property
    def token_to_idx(self):
        return self._token_to_idx

    @property
    def idx_to_token(self):
        return self._idx_to_token

    @property
    def unknown_token(self):
        return self._unknown_token

    @property
    def reserved_tokens(self):
        return self._reserved_tokens

    def to_indices(self, tokens):
        single = isinstance(tokens, str)
        toks = [tokens] if single else tokens
        out = [self._token_to_idx.get(t, 0) for t in toks]
        return out[0] if single else out

    def to_tokens(self, indices):
        single = isinstance(indices, int)
        idxs = [indices] if single else indices
        for i in idxs:
            if not 0 <= i < len(self):
                raise MXNetError("token index %d out of range" % i)
        out = [self._idx_to_token[i] for i in idxs]
        return out[0] if single else out


class TokenEmbedding(Vocabulary):
    """Pretrained token embeddings over a vocabulary (reference:
    contrib/text/embedding.py:141). The table is ONE (V, D) NDArray;
    unknown tokens get ``init_unknown_vec`` rows."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self._vec_len = 0
        self._idx_to_vec = None

    @property
    def vec_len(self):
        return self._vec_len

    @property
    def idx_to_vec(self):
        return self._idx_to_vec

    def _load_embedding_file(self, file_path, elem_delim=" ",
                             encoding="utf8"):
        table = {}
        dim = None
        with open(file_path, encoding=encoding) as f:
            for lineno, line in enumerate(f):
                cells = line.rstrip().split(elem_delim)
                if len(cells) < 2:
                    continue
                if lineno == 0 and len(cells) == 2 and \
                        all(c.isdigit() for c in cells):
                    continue            # word2vec "vocab dim" header
                vec = [float(x) for x in cells[1:] if x]
                if dim is None:
                    dim = len(vec)
                if len(vec) != dim:
                    continue            # malformed row
                table[cells[0]] = vec
        if dim is None:
            raise MXNetError("no vectors found in %s" % file_path)
        return table, dim

    def _build_table(self, loaded, dim, init_unknown_vec):
        self._vec_len = dim
        mat = np.array(init_unknown_vec(shape=(len(self), dim))
                       .asnumpy())
        for i, token in enumerate(self._idx_to_token):
            if token in loaded:
                mat[i] = loaded[token]
        self._idx_to_vec = nd.array(mat)

    def get_vecs_by_tokens(self, tokens, lower_case_backup=False):
        single = isinstance(tokens, str)
        toks = [tokens] if single else tokens
        idxs = []
        for t in toks:
            i = self._token_to_idx.get(t, 0)
            if i == 0 and lower_case_backup:
                i = self._token_to_idx.get(t.lower(), 0)
            idxs.append(i)
        vecs = self._idx_to_vec.take(
            nd.array(idxs, dtype="int32", ctx=self._idx_to_vec.context))
        return vecs[0] if single else vecs

    def update_token_vectors(self, tokens, new_vectors):
        toks = [tokens] if isinstance(tokens, str) else tokens
        idxs = [self._token_to_idx[t] for t in toks]
        data = np.array(self._idx_to_vec.asnumpy())
        data[np.asarray(idxs)] = new_vectors.asnumpy().reshape(
            len(idxs), -1)
        self._idx_to_vec = nd.array(data, ctx=self._idx_to_vec.context)


class CustomEmbedding(TokenEmbedding):
    """Embeddings loaded from a user's token-vector file (reference:
    contrib/text/embedding.py CustomEmbedding)."""

    def __init__(self, pretrained_file_path, elem_delim=" ",
                 encoding="utf8", init_unknown_vec=nd.zeros,
                 vocabulary=None, **kwargs):
        loaded, dim = self._load_embedding_file(
            pretrained_file_path, elem_delim, encoding)
        if vocabulary is not None:
            self.__dict__.update(vocabulary.__dict__)
        else:
            super().__init__(counter=collections.Counter(loaded.keys()),
                             **kwargs)
        self._build_table(loaded, dim, init_unknown_vec)
