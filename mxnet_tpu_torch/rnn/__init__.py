"""Symbolic RNN package (counterpart of ``mxnet_tpu/rnn``; reference:
python/mxnet/rnn/).

Cells compose Symbols for the Module API, most importantly
``BucketingModule`` for variable-length sequence training (BASELINE
config 3: the LSTM language model on PTB). The Gluon-side cells live in
``gluon.rnn``; this package is their symbolic twin with the reference's
parameter naming, so checkpoints move between the packages.
"""
from .rnn_cell import (RNNParams, BaseRNNCell, RNNCell, LSTMCell, GRUCell,
                       FusedRNNCell, SequentialRNNCell, BidirectionalCell,
                       DropoutCell, ModifierCell, ResidualCell,
                       ZoneoutCell)
from .io import BucketSentenceIter, encode_sentences
