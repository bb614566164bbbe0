"""Gluon RNN cells (counterpart of ``mxnet_tpu/gluon/rnn/rnn_cell.py``;
API of python/mxnet/gluon/rnn/rnn_cell.py).

Sequence layout handling is a small codec (:func:`_split_steps` /
:func:`_join_steps` under :func:`_format_sequence`), the three gate
cells share one ``_GateCell`` base that owns i2h/h2h parameter creation
and the input-size repr, and the two sequential containers share a
``_CellChain`` mixin. Unrolling stays explicit (bucketing bounds the
set of graphs); the fused whole-sequence path lives in rnn_layer.py on
the ``RNN`` op.
"""
from __future__ import annotations

from ... import ndarray as nd
from ... import symbol as sym_mod
from ..block import Block, HybridBlock

__all__ = ["RecurrentCell", "HybridRecurrentCell", "RNNCell", "LSTMCell",
           "GRUCell", "SequentialRNNCell", "HybridSequentialRNNCell",
           "DropoutCell", "ModifierCell", "ZoneoutCell", "ResidualCell",
           "BidirectionalCell"]

_TENSOR_TYPES = None


def _indent(text, num_spaces):
    """Every line of ``text`` but the first indented (nested reprs)."""
    first, *rest = text.split("\n")
    return "\n".join([first] + [" " * num_spaces + line for line in rest])


def _tensorish(x):
    global _TENSOR_TYPES
    if _TENSOR_TYPES is None:
        _TENSOR_TYPES = (nd.NDArray, sym_mod.Symbol)
    return isinstance(x, _TENSOR_TYPES)


def _namespace_of(x):
    probe = x[0] if isinstance(x, (list, tuple)) else x
    return sym_mod if isinstance(probe, sym_mod.Symbol) else nd


def _split_steps(F, seq, length, axis):
    """One merged tensor → list of per-step tensors (time axis
    squeezed). Indexed explicitly: for length 1 the split op returns a
    bare tensor whose list() would iterate the batch axis."""
    if F is sym_mod:
        parts = F.SliceChannel(seq, axis=axis, num_outputs=length,
                               squeeze_axis=1)
        return [parts[i] for i in range(length)] if length > 1 \
            else [parts]
    parts = F.split(seq, num_outputs=length, axis=axis,
                    squeeze_axis=True)
    return list(parts) if isinstance(parts, (list, tuple)) else [parts]


def _join_steps(F, steps, axis):
    """List of per-step tensors → one tensor with a new time axis."""
    widened = [F.expand_dims(s, axis=axis) for s in steps]
    return F.Concat(*widened, dim=axis)


_stack_seq = _join_steps        # legacy helper name


def _cells_state_info(cells, batch_size):
    infos = []
    for c in cells:
        infos.extend(c.state_info(batch_size))
    return infos


def _cells_begin_state(cells, **kwargs):
    states = []
    for c in cells:
        states.extend(c.begin_state(**kwargs))
    return states


def _get_begin_state(cell, F, begin_state, inputs, batch_size):
    if begin_state is not None:
        return begin_state
    probe = inputs[0] if isinstance(inputs, (list, tuple)) else inputs
    ctx = getattr(probe, "context", None)
    with cell.name_scope():
        return cell.begin_state(func=nd.zeros, batch_size=batch_size,
                                ctx=ctx)


def _format_sequence(length, inputs, layout, merge, in_layout=None):
    """Normalize ``inputs`` to the requested merged-vs-stepped form.

    Returns (inputs, time_axis, F, batch_size). ``merge=False`` yields
    a python list of steps; ``merge=True`` one stacked tensor; ``None``
    leaves the incoming form alone.
    """
    if inputs is None:
        raise AssertionError(
            "unroll(inputs=None) only works for HybridBlock trace")
    axis = layout.find('T')
    batch_axis = layout.find('N')
    in_axis = in_layout.find('T') if in_layout is not None else axis
    batch_size = 0

    if _tensorish(inputs):
        F = _namespace_of(inputs)
        if F is nd:
            batch_size = inputs.shape[batch_axis]
            if merge is False and length is not None and \
                    length != inputs.shape[in_axis]:
                raise AssertionError(
                    "sequence length %s does not match inputs"
                    % (length,))
        if merge is False:
            n = length if F is sym_mod else inputs.shape[in_axis]
            inputs = _split_steps(F, inputs, n, in_axis)
    else:
        if length is not None and len(inputs) != length:
            raise AssertionError(
                "len(inputs) %d != length %d" % (len(inputs), length))
        F = _namespace_of(inputs)
        if F is nd:
            batch_size = inputs[0].shape[batch_axis]
        if merge is True:
            inputs = _join_steps(F, inputs, axis)
    if _tensorish(inputs) and axis != in_axis:
        inputs = F.swapaxes(inputs, dim1=axis, dim2=in_axis)
    return inputs, axis, F, batch_size


def _mask_sequence_variable_length(F, data, length, valid_length,
                                   time_axis, merge):
    if valid_length is None:
        raise AssertionError("valid_length required for masking")
    if not _tensorish(data):
        data = _join_steps(F, data, time_axis)
    masked = F.SequenceMask(data, sequence_length=valid_length,
                            use_sequence_length=True, axis=time_axis)
    if merge:
        return masked
    return _split_steps(F, masked, data.shape[time_axis], time_axis)


# ---------------------------------------------------------------------------
# base cells
# ---------------------------------------------------------------------------

class RecurrentCell(Block):
    """Abstract step-wise RNN cell (reference: rnn_cell.py:77)."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._modified = False
        self.reset()

    def reset(self):
        self._init_counter = self._counter = -1
        for child in self._children.values():
            child.reset()

    def state_info(self, batch_size=0):
        raise NotImplementedError()

    def begin_state(self, batch_size=0, func=nd.zeros, **kwargs):
        if self._modified:
            raise AssertionError(
                "After applying modifier cells (e.g. ZoneoutCell) the "
                "base cell cannot be called directly. Call the modifier "
                "cell instead.")
        kwargs.pop('name', None)
        ctx = kwargs.get('ctx', None)
        dtype = kwargs.get('dtype', 'float32')
        states = []
        for info in self.state_info(batch_size):
            self._init_counter += 1
            shape = (info or {}).get('shape', ())
            states.append(func(shape, ctx=ctx, dtype=dtype))
        return states

    def _finalize_unroll(self, F, outputs, states, all_states, length,
                         axis, merge_outputs, valid_length):
        """Shared tail of unroll: variable-length masking + merge."""
        if valid_length is not None:
            states = [F.SequenceLast(_join_steps(F, chain, 0),
                                     sequence_length=valid_length,
                                     use_sequence_length=True, axis=0)
                      for chain in zip(*all_states)]
            outputs = _mask_sequence_variable_length(
                F, outputs, length, valid_length, axis, True)
        if merge_outputs is None:
            merge_outputs = _tensorish(outputs)
        if merge_outputs and not _tensorish(outputs):
            outputs = _join_steps(F, outputs, axis)
        elif not merge_outputs and _tensorish(outputs):
            outputs = _split_steps(F, outputs, length, axis)
        return outputs, states

    def unroll(self, length, inputs, begin_state=None, layout='NTC',
               merge_outputs=None, valid_length=None):
        """Explicit unrolling over time (reference: rnn_cell.py:167)."""
        self.reset()
        steps, axis, F, batch_size = _format_sequence(length, inputs,
                                                      layout, False)
        states = _get_begin_state(self, F, begin_state, steps,
                                  batch_size)
        outputs, trail = [], []
        for t in range(length):
            out, states = self(steps[t], states)
            outputs.append(out)
            if valid_length is not None:
                trail.append(states)
        return self._finalize_unroll(F, outputs, states, trail, length,
                                     axis, merge_outputs, valid_length)

    def _get_activation(self, F, inputs, activation, **kwargs):
        if not isinstance(activation, str):
            return activation(inputs, **kwargs)
        direct = {'tanh': F.tanh, 'relu': F.relu, 'sigmoid': F.sigmoid,
                  'softsign': F.softsign}.get(activation)
        if direct is not None:
            return direct(inputs, **kwargs)
        return F.Activation(inputs, act_type=activation, **kwargs)

    def forward(self, inputs, states):
        self._counter += 1
        return super().forward(inputs, states)


class HybridRecurrentCell(RecurrentCell, HybridBlock):
    """Hybridizable recurrent cell (reference: rnn_cell.py:270)."""

    def forward(self, inputs, states):
        self._counter += 1
        return HybridBlock.forward(self, inputs, states)

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError()


# ---------------------------------------------------------------------------
# gate cells (RNN / LSTM / GRU)
# ---------------------------------------------------------------------------

class _GateCell(HybridRecurrentCell):
    """Shared plumbing for gate-based cells: i2h/h2h parameter pairs
    sized ``gates * hidden`` and the in→out repr."""

    _GATES = 1

    def __init__(self, hidden_size, input_size, i2h_weight_initializer,
                 h2h_weight_initializer, i2h_bias_initializer,
                 h2h_bias_initializer, prefix, params):
        super().__init__(prefix=prefix, params=params)
        self._hidden_size = hidden_size
        self._input_size = input_size
        g = self._GATES
        for side, width, w_init, b_init in (
                ("i2h", input_size, i2h_weight_initializer,
                 i2h_bias_initializer),
                ("h2h", hidden_size, h2h_weight_initializer,
                 h2h_bias_initializer)):
            setattr(self, side + "_weight", self.params.get(
                side + "_weight", shape=(g * hidden_size, width),
                init=w_init, allow_deferred_init=True))
            setattr(self, side + "_bias", self.params.get(
                side + "_bias", shape=(g * hidden_size,),
                init=b_init, allow_deferred_init=True))

    def _one_state_info(self, batch_size):
        return {'shape': (batch_size, self._hidden_size),
                '__layout__': 'NC'}

    def state_info(self, batch_size=0):
        return [self._one_state_info(batch_size)]

    def _gate_pre(self, F, inputs, state_h, i2h_weight, h2h_weight,
                  i2h_bias, h2h_bias, prefix):
        """The two projections every gate cell starts with."""
        width = self._GATES * self._hidden_size
        i2h = F.FullyConnected(inputs, i2h_weight, i2h_bias,
                               num_hidden=width, name=prefix + 'i2h')
        h2h = F.FullyConnected(state_h, h2h_weight, h2h_bias,
                               num_hidden=width, name=prefix + 'h2h')
        return i2h, h2h

    def __repr__(self):
        shape = self.i2h_weight.shape
        extra = ', %s' % self._activation \
            if getattr(self, '_activation', None) and \
            type(self) is RNNCell else ''
        return '{}({} -> {}{})'.format(
            type(self).__name__, shape[1] if shape[1] else None,
            shape[0], extra)


class RNNCell(_GateCell):
    """Elman cell: act(i2h + h2h) (reference: rnn_cell.py:289)."""

    _GATES = 1

    def __init__(self, hidden_size, activation='tanh',
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer='zeros',
                 h2h_bias_initializer='zeros', input_size=0, prefix=None,
                 params=None):
        super().__init__(hidden_size, input_size,
                         i2h_weight_initializer, h2h_weight_initializer,
                         i2h_bias_initializer, h2h_bias_initializer,
                         prefix, params)
        self._activation = activation

    def _alias(self):
        return 'rnn'

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        tag = 't%d_' % self._counter
        i2h, h2h = self._gate_pre(F, inputs, states[0], i2h_weight,
                                  h2h_weight, i2h_bias, h2h_bias, tag)
        out = self._get_activation(F, i2h + h2h, self._activation,
                                   name=tag + 'out')
        return out, [out]


class LSTMCell(_GateCell):
    """LSTM with (in, forget, cell, out) gate order
    (reference: rnn_cell.py:389)."""

    _GATES = 4

    def __init__(self, hidden_size, i2h_weight_initializer=None,
                 h2h_weight_initializer=None,
                 i2h_bias_initializer='zeros',
                 h2h_bias_initializer='zeros', input_size=0, prefix=None,
                 params=None, activation='tanh',
                 recurrent_activation='sigmoid'):
        super().__init__(hidden_size, input_size,
                         i2h_weight_initializer, h2h_weight_initializer,
                         i2h_bias_initializer, h2h_bias_initializer,
                         prefix, params)
        self._activation = activation
        self._recurrent_activation = recurrent_activation

    def state_info(self, batch_size=0):
        return [self._one_state_info(batch_size),
                self._one_state_info(batch_size)]

    def _alias(self):
        return 'lstm'

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        tag = 't%d_' % self._counter
        i2h, h2h = self._gate_pre(F, inputs, states[0], i2h_weight,
                                  h2h_weight, i2h_bias, h2h_bias, tag)
        pieces = F.SliceChannel(i2h + h2h, num_outputs=4,
                                name=tag + 'slice')
        act_r = self._recurrent_activation
        gate_in = self._get_activation(F, pieces[0], act_r,
                                       name=tag + 'i')
        gate_forget = self._get_activation(F, pieces[1], act_r,
                                           name=tag + 'f')
        candidate = self._get_activation(F, pieces[2], self._activation,
                                         name=tag + 'c')
        gate_out = self._get_activation(F, pieces[3], act_r,
                                        name=tag + 'o')
        next_c = gate_forget * states[1] + gate_in * candidate
        next_h = gate_out * self._get_activation(
            F, next_c, self._activation, name=tag + 'state')
        return next_h, [next_h, next_c]


class GRUCell(_GateCell):
    """GRU with (reset, update, new) gate order
    (reference: rnn_cell.py:519)."""

    _GATES = 3

    def __init__(self, hidden_size, i2h_weight_initializer=None,
                 h2h_weight_initializer=None,
                 i2h_bias_initializer='zeros',
                 h2h_bias_initializer='zeros', input_size=0, prefix=None,
                 params=None, activation='tanh',
                 recurrent_activation='sigmoid'):
        super().__init__(hidden_size, input_size,
                         i2h_weight_initializer, h2h_weight_initializer,
                         i2h_bias_initializer, h2h_bias_initializer,
                         prefix, params)
        self._activation = activation
        self._recurrent_activation = recurrent_activation

    def _alias(self):
        return 'gru'

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        tag = 't%d_' % self._counter
        prev_h = states[0]
        i2h, h2h = self._gate_pre(F, inputs, prev_h, i2h_weight,
                                  h2h_weight, i2h_bias, h2h_bias, tag)
        ir, iz, ih = F.SliceChannel(i2h, num_outputs=3,
                                    name=tag + 'i2h_slice')
        hr, hz, hh = F.SliceChannel(h2h, num_outputs=3,
                                    name=tag + 'h2h_slice')
        act_r = self._recurrent_activation
        reset = self._get_activation(F, ir + hr, act_r,
                                     name=tag + 'r_act')
        update = self._get_activation(F, iz + hz, act_r,
                                      name=tag + 'z_act')
        candidate = self._get_activation(F, ih + reset * hh,
                                         self._activation,
                                         name=tag + 'h_act')
        next_h = (F.ones_like(update) - update) * candidate \
            + update * prev_h
        return next_h, [next_h]


# ---------------------------------------------------------------------------
# containers
# ---------------------------------------------------------------------------

class _CellChain:
    """Shared container plumbing for the two sequential stacks."""

    def add(self, cell):
        self.register_child(cell)

    def __getitem__(self, i):
        return list(self._children.values())[i]

    def __len__(self):
        return len(self._children)

    def __repr__(self):
        rows = ['({}): {}'.format(i, _indent(repr(m), 2))
                for i, m in enumerate(self._children.values())]
        return '{}(\n{}\n)'.format(type(self).__name__, '\n'.join(rows))

    def state_info(self, batch_size=0):
        return _cells_state_info(self._children.values(), batch_size)

    def begin_state(self, **kwargs):
        assert not self._modified
        return _cells_begin_state(self._children.values(), **kwargs)

    def _step_children(self, inputs, states):
        chained = []
        pos = 0
        for cell in self._children.values():
            if isinstance(cell, BidirectionalCell):
                raise AssertionError(
                    "BidirectionalCell cannot be stepped inside a "
                    "sequential stack; use unroll")
            n = len(cell.state_info())
            inputs, fresh = cell(inputs, states[pos:pos + n])
            pos += n
            chained.extend(fresh)
        return inputs, chained

    def unroll(self, length, inputs, begin_state=None, layout='NTC',
               merge_outputs=None, valid_length=None):
        """Layer-major: each cell unrolls the whole sequence before the
        next (reference: rnn_cell.py:714)."""
        self.reset()
        inputs, _, F, batch_size = _format_sequence(length, inputs,
                                                    layout, None)
        begin = _get_begin_state(self, F, begin_state, inputs,
                                 batch_size)
        pos = 0
        collected = []
        last = len(self._children) - 1
        for i, cell in enumerate(self._children.values()):
            n = len(cell.state_info())
            inputs, states = cell.unroll(
                length, inputs=inputs,
                begin_state=begin[pos:pos + n], layout=layout,
                merge_outputs=merge_outputs if i == last else None,
                valid_length=valid_length)
            pos += n
            collected.extend(states)
        return inputs, collected


class SequentialRNNCell(_CellChain, RecurrentCell):
    """Imperative stack of cells (reference: rnn_cell.py:646)."""

    def __call__(self, inputs, states):
        self._counter += 1
        return self._step_children(inputs, states)

    def forward(self, *args, **kwargs):
        raise NotImplementedError


class HybridSequentialRNNCell(_CellChain, HybridRecurrentCell):
    """Hybridizable stack (reference: rnn_cell.py:746)."""

    def __call__(self, inputs, states):
        self._counter += 1
        return self._step_children(inputs, states)

    def hybrid_forward(self, *args, **kwargs):
        raise NotImplementedError


class DropoutCell(HybridRecurrentCell):
    """Dropout applied per step (reference: rnn_cell.py:795)."""

    def __init__(self, rate, axes=(), prefix=None, params=None):
        super().__init__(prefix, params)
        if not isinstance(rate, float):
            raise AssertionError("rate must be a float")
        self._rate, self._axes = rate, axes

    def __repr__(self):
        return '{}(rate={}, axes={})'.format(
            type(self).__name__, self._rate, self._axes)

    def state_info(self, batch_size=0):
        return []

    def _alias(self):
        return 'dropout'

    def hybrid_forward(self, F, inputs, states):
        if self._rate > 0:
            inputs = F.Dropout(inputs, p=self._rate, axes=self._axes,
                               name='t%d_fwd' % self._counter)
        return inputs, states

    def unroll(self, length, inputs, begin_state=None, layout='NTC',
               merge_outputs=None, valid_length=None):
        self.reset()
        inputs, _, F, _ = _format_sequence(length, inputs, layout,
                                           merge_outputs)
        if _tensorish(inputs):
            # whole-sequence dropout in one op
            return self.hybrid_forward(F, inputs, [])
        return super().unroll(length, inputs, begin_state=begin_state,
                              layout=layout,
                              merge_outputs=merge_outputs,
                              valid_length=valid_length)


# ---------------------------------------------------------------------------
# modifiers
# ---------------------------------------------------------------------------

class ModifierCell(HybridRecurrentCell):
    """Wraps a cell, borrowing its parameters and states
    (reference: rnn_cell.py:862)."""

    def __init__(self, base_cell):
        if base_cell._modified:
            raise AssertionError(
                "Cell %s is already modified. One cell cannot be "
                "modified twice" % base_cell.name)
        base_cell._modified = True
        super().__init__(prefix=base_cell.prefix + self._alias(),
                         params=None)
        self.base_cell = base_cell

    @property
    def params(self):
        return self.base_cell.params

    def state_info(self, batch_size=0):
        return self.base_cell.state_info(batch_size)

    def begin_state(self, func=nd.zeros, **kwargs):
        assert not self._modified
        self.base_cell._modified = False
        try:
            return self.base_cell.begin_state(func=func, **kwargs)
        finally:
            self.base_cell._modified = True

    def hybrid_forward(self, F, inputs, states):
        raise NotImplementedError

    def __repr__(self):
        return '{}({})'.format(type(self).__name__, self.base_cell)


class ZoneoutCell(ModifierCell):
    """Zoneout regularization (reference: rnn_cell.py:922)."""

    def __init__(self, base_cell, zoneout_outputs=0., zoneout_states=0.):
        if isinstance(base_cell, BidirectionalCell):
            raise AssertionError(
                "BidirectionalCell doesn't support zoneout. Apply "
                "ZoneoutCell to the cells underneath instead.")
        self._zoneout_outputs = zoneout_outputs
        self._zoneout_states = zoneout_states
        super().__init__(base_cell)
        self._prev_output = None

    def __repr__(self):
        return '{}(p_out={}, p_state={}, {})'.format(
            type(self).__name__, self._zoneout_outputs,
            self._zoneout_states, self.base_cell)

    def _alias(self):
        return 'zoneout'

    def reset(self):
        super().reset()
        self._prev_output = None

    def hybrid_forward(self, F, inputs, states):
        p_out, p_state = self._zoneout_outputs, self._zoneout_states
        new_out, new_states = self.base_cell(inputs, states)

        def zone(p, fresh, old):
            keep = F.Dropout(F.ones_like(fresh), p=p)
            return F.where(keep, fresh, old)

        prev = self._prev_output
        if prev is None:
            prev = F.zeros_like(new_out)
        out = zone(p_out, new_out, prev) if p_out != 0. else new_out
        if p_state != 0.:
            new_states = [zone(p_state, s_new, s_old)
                          for s_new, s_old in zip(new_states, states)]
        self._prev_output = out
        return out, new_states


class ResidualCell(ModifierCell):
    """Adds the input back onto the cell's output
    (reference: rnn_cell.py:984)."""

    def hybrid_forward(self, F, inputs, states):
        out, states = self.base_cell(inputs, states)
        return out + inputs, states

    def unroll(self, length, inputs, begin_state=None, layout='NTC',
               merge_outputs=None, valid_length=None):
        self.reset()
        self.base_cell._modified = False
        try:
            outputs, states = self.base_cell.unroll(
                length, inputs=inputs, begin_state=begin_state,
                layout=layout, merge_outputs=merge_outputs,
                valid_length=valid_length)
        finally:
            self.base_cell._modified = True
        if merge_outputs is None:
            merge_outputs = _tensorish(outputs)
        inputs, axis, F, _ = _format_sequence(length, inputs, layout,
                                              merge_outputs)
        if valid_length is not None:
            inputs = _mask_sequence_variable_length(
                F, inputs, length, valid_length, axis, merge_outputs)
        if merge_outputs:
            return outputs + inputs, states
        return [o + i for o, i in zip(outputs, inputs)], states


class BidirectionalCell(HybridRecurrentCell):
    """Forward + time-reversed cell with concatenated outputs
    (reference: rnn_cell.py:1034)."""

    def __init__(self, l_cell, r_cell, output_prefix='bi_'):
        super().__init__(prefix='', params=None)
        self.register_child(l_cell, 'l_cell')
        self.register_child(r_cell, 'r_cell')
        self._output_prefix = output_prefix

    def __call__(self, inputs, states):
        raise NotImplementedError(
            "Bidirectional cannot be stepped. Please use unroll")

    def __repr__(self):
        return '{}(forward={}, backward={})'.format(
            type(self).__name__, self._children['l_cell'],
            self._children['r_cell'])

    def state_info(self, batch_size=0):
        return _cells_state_info(self._children.values(), batch_size)

    def begin_state(self, **kwargs):
        assert not self._modified
        return _cells_begin_state(self._children.values(), **kwargs)

    def unroll(self, length, inputs, begin_state=None, layout='NTC',
               merge_outputs=None, valid_length=None):
        self.reset()
        steps, axis, F, batch_size = _format_sequence(length, inputs,
                                                      layout, False)
        begin = _get_begin_state(self, F, begin_state, steps, batch_size)
        fwd, bwd = self._children.values()
        n_fwd = len(fwd.state_info(batch_size))
        f_out, f_states = fwd.unroll(
            length, inputs=steps, begin_state=begin[:n_fwd],
            layout=layout, merge_outputs=False,
            valid_length=valid_length)
        b_out, b_states = bwd.unroll(
            length, inputs=list(reversed(steps)),
            begin_state=begin[n_fwd:], layout=layout,
            merge_outputs=False, valid_length=valid_length)
        if valid_length is None:
            b_aligned = list(reversed(b_out))
        else:
            seq = F.SequenceReverse(_join_steps(F, b_out, 0),
                                    sequence_length=valid_length,
                                    use_sequence_length=True, axis=0)
            b_aligned = _split_steps(F, seq, length, 0)
        outputs = [F.Concat(f, b, dim=1)
                   for f, b in zip(f_out, b_aligned)]
        if merge_outputs:
            outputs = _join_steps(F, outputs, axis)
        return outputs, f_states + b_states
