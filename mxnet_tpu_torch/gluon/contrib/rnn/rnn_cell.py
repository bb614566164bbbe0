"""Contrib RNN cells (counterpart of
``mxnet_tpu/gluon/contrib/rnn/rnn_cell.py``; API of
python/mxnet/gluon/contrib/rnn/rnn_cell.py)."""
from __future__ import annotations

from ...rnn.rnn_cell import ModifierCell, HybridRecurrentCell, \
    BidirectionalCell, SequentialRNNCell

__all__ = ["VariationalDropoutCell", "LSTMPCell"]


class VariationalDropoutCell(ModifierCell):
    """The same dropout mask at every time step (reference:
    contrib/rnn/rnn_cell.py:33). A mask is drawn at the first step of an
    unroll and reused by the later ones; ``reset()`` (which ``unroll``
    calls first) clears it, so each unroll draws its own. Inside a
    hybridized block the mask is one ``Dropout`` node of the traced
    graph, drawn anew at each call."""

    def __init__(self, base_cell, drop_inputs=0., drop_states=0.,
                 drop_outputs=0.):
        assert not drop_states or not isinstance(base_cell,
                                                 BidirectionalCell), \
            "BidirectionalCell doesn't support variational state dropout. " \
            "Apply VariationalDropoutCell to the cells underneath instead."
        assert not drop_states or not (
            isinstance(base_cell, SequentialRNNCell)
            and getattr(base_cell, "_bidirectional", False))
        super().__init__(base_cell)
        self.drop_inputs = drop_inputs
        self.drop_states = drop_states
        self.drop_outputs = drop_outputs
        self.drop_inputs_mask = None
        self.drop_states_mask = None
        self.drop_outputs_mask = None

    def _alias(self):
        return 'vardrop'

    def reset(self):
        super().reset()
        self.drop_inputs_mask = None
        self.drop_states_mask = None
        self.drop_outputs_mask = None

    def _initialize_input_masks(self, F, inputs, states):
        if self.drop_states and self.drop_states_mask is None:
            self.drop_states_mask = F.Dropout(
                F.ones_like(states[0]), p=self.drop_states)
        if self.drop_inputs and self.drop_inputs_mask is None:
            self.drop_inputs_mask = F.Dropout(
                F.ones_like(inputs), p=self.drop_inputs)

    def _initialize_output_mask(self, F, output):
        if self.drop_outputs and self.drop_outputs_mask is None:
            self.drop_outputs_mask = F.Dropout(
                F.ones_like(output), p=self.drop_outputs)

    def hybrid_forward(self, F, inputs, states):
        self._initialize_input_masks(F, inputs, states)
        if self.drop_states:
            states = list(states)
            states[0] = states[0] * self.drop_states_mask
        if self.drop_inputs:
            inputs = inputs * self.drop_inputs_mask
        next_output, next_states = self.base_cell(inputs, states)
        self._initialize_output_mask(F, next_output)
        if self.drop_outputs:
            next_output = next_output * self.drop_outputs_mask
        return next_output, next_states

    def __repr__(self):
        return '{name}(p_out = {drop_outputs}, p_state = {drop_states})' \
            .format(name=type(self).__name__, **self.__dict__)


class LSTMPCell(HybridRecurrentCell):
    """LSTM with a projection of its hidden state (reference:
    contrib/rnn/rnn_cell.py LSTMPCell): the recurrent state is
    ``r = h2r(o * tanh(c))`` of ``projection_size``."""

    def __init__(self, hidden_size, projection_size,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 h2r_weight_initializer=None, i2h_bias_initializer='zeros',
                 h2h_bias_initializer='zeros', input_size=0, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        self._hidden_size = hidden_size
        self._projection_size = projection_size
        self._input_size = input_size
        self.i2h_weight = self.params.get(
            'i2h_weight', shape=(4 * hidden_size, input_size),
            init=i2h_weight_initializer, allow_deferred_init=True)
        self.h2h_weight = self.params.get(
            'h2h_weight', shape=(4 * hidden_size, projection_size),
            init=h2h_weight_initializer, allow_deferred_init=True)
        self.h2r_weight = self.params.get(
            'h2r_weight', shape=(projection_size, hidden_size),
            init=h2r_weight_initializer, allow_deferred_init=True)
        self.i2h_bias = self.params.get(
            'i2h_bias', shape=(4 * hidden_size,),
            init=i2h_bias_initializer, allow_deferred_init=True)
        self.h2h_bias = self.params.get(
            'h2h_bias', shape=(4 * hidden_size,),
            init=h2h_bias_initializer, allow_deferred_init=True)

    def state_info(self, batch_size=0):
        return [{'shape': (batch_size, self._projection_size),
                 '__layout__': 'NC'},
                {'shape': (batch_size, self._hidden_size),
                 '__layout__': 'NC'}]

    def _alias(self):
        return 'lstmp'

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       h2r_weight, i2h_bias, h2h_bias):
        prefix = 't%d_' % self._counter
        i2h = F.FullyConnected(inputs, i2h_weight, i2h_bias,
                               num_hidden=self._hidden_size * 4,
                               name=prefix + 'i2h')
        h2h = F.FullyConnected(states[0], h2h_weight, h2h_bias,
                               num_hidden=self._hidden_size * 4,
                               name=prefix + 'h2h')
        gates = F.SliceChannel(i2h + h2h, num_outputs=4,
                               name=prefix + 'slice')
        in_gate = F.sigmoid(gates[0])
        forget_gate = F.sigmoid(gates[1])
        in_transform = F.tanh(gates[2])
        out_gate = F.sigmoid(gates[3])
        next_c = forget_gate * states[1] + in_gate * in_transform
        hidden = out_gate * F.tanh(next_c)
        next_r = F.FullyConnected(hidden, h2r_weight,
                                  num_hidden=self._projection_size,
                                  no_bias=True, name=prefix + 'out')
        return next_r, [next_r, next_c]
