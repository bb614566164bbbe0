"""Gluon RNN namespace (counterpart of ``mxnet_tpu/gluon/rnn``; API of
python/mxnet/gluon/rnn/)."""
from .rnn_layer import RNN, LSTM, GRU
from .rnn_cell import (RecurrentCell, HybridRecurrentCell, RNNCell,
                       LSTMCell, GRUCell, SequentialRNNCell,
                       HybridSequentialRNNCell, DropoutCell, ModifierCell,
                       ZoneoutCell, ResidualCell, BidirectionalCell)
