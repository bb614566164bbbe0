"""Symbolic RNN cells (counterpart of ``mxnet_tpu/rnn/rnn_cell.py``;
reference: python/mxnet/rnn/rnn_cell.py).

Every cell is a step function over Symbols; ``unroll`` lays the steps
out explicitly (bucketing bounds the number of distinct graphs, one per
bucket length, each captured once by the fused step), and
``FusedRNNCell`` lowers the whole sequence to the fused ``RNN``
operator (``ops/rnn_op.py``: one input projection, then a loop over
time), the role the cuDNN fused kernel plays in the reference
(src/operator/rnn-inl.h:380).

Parameter names follow the reference (``<prefix>i2h_weight`` etc.), the
JAX package's too, so ``arg_params`` move between the packages by name.
"""
from __future__ import annotations

from ..base import MXNetError
from ..symbol import symbol as _symbol
from .. import symbol as sym

__all__ = ["RNNParams", "BaseRNNCell", "RNNCell", "LSTMCell", "GRUCell",
           "FusedRNNCell", "SequentialRNNCell", "BidirectionalCell",
           "DropoutCell", "ModifierCell", "ResidualCell", "ZoneoutCell"]


class RNNParams:
    """Lazily-created shared variables scoped by a prefix (reference:
    rnn_cell.py RNNParams)."""

    def __init__(self, prefix=""):
        self._prefix = prefix
        self._vars = {}

    def get(self, name, **kwargs):
        full = self._prefix + name
        if full not in self._vars:
            self._vars[full] = _symbol.var(full, **kwargs)
        return self._vars[full]


def _zeros_like_state(x, num_hidden):
    """A (batch, num_hidden) zero Symbol derived from a step input
    ``x`` of shape (batch, feature) — no static batch size needed."""
    col = sym.slice_axis(x, axis=1, begin=0, end=1) * 0.0
    return sym.tile(col, reps=(1, num_hidden))


def _first_step_input(inputs, length, layout):
    axis = layout.find("T")
    if isinstance(inputs, (list, tuple)):
        return inputs[0]
    flat = sym.slice_axis(inputs, axis=axis, begin=0, end=1)
    return sym.Reshape(flat, shape=(0, -1)) if axis == 1 else \
        sym.Reshape(flat, shape=(-3, -1))


class BaseRNNCell:
    """Abstract cell: a step function plus unrolling machinery."""

    def __init__(self, prefix="", params=None):
        if params is None:
            params = RNNParams(prefix)
            self._own_params = True
        else:
            self._own_params = False
        self._prefix = prefix
        self._params = params
        self._modified = False
        self.reset()

    @property
    def params(self):
        self._own_params = False
        return self._params

    @property
    def prefix(self):
        return self._prefix

    def reset(self):
        self._init_counter = -1
        self._counter = -1

    # -- to implement per cell -------------------------------------------
    @property
    def state_info(self):
        """[{'shape': (0, H), '__layout__': 'NC'}, ...] per state."""
        raise NotImplementedError

    def __call__(self, inputs, states):
        """One step: (output, new_states)."""
        raise NotImplementedError

    # -- shared machinery -------------------------------------------------
    @property
    def _gate_names(self):
        return ()

    def begin_state(self, func=None, x=None, **kwargs):
        """Initial states. With ``x`` (a step input Symbol) states are
        zeros derived in-graph — no batch size needed. Otherwise
        ``func`` (e.g. ``mx.sym.zeros``) builds them from
        ``state_info`` shapes with ``batch_size`` substituted."""
        if self._modified:
            raise MXNetError(
                "After applying a modifier cell (e.g. Dropout/Zoneout), "
                "call begin_state on the base cell instead")
        self._init_counter += 1
        states = []
        for i, info in enumerate(self.state_info):
            if x is not None:
                states.append(_zeros_like_state(x, info["shape"][-1]))
                continue
            if func is None:
                raise MXNetError(
                    "begin_state needs either x= (derive zeros in-graph) "
                    "or func= with a concrete batch_size")
            shape = tuple(info["shape"])
            bs = kwargs.get("batch_size")
            if bs:
                # the batch axis is where __layout__ says N is (LNC for
                # fused cells, NC for step cells)
                n_axis = info.get("__layout__", "NC").find("N")
                if 0 <= n_axis < len(shape) and shape[n_axis] == 0:
                    shape = shape[:n_axis] + (bs,) + shape[n_axis + 1:]
            states.append(func(
                name="%sbegin_state_%d_%d" % (self._prefix,
                                              self._init_counter, i),
                shape=shape))
        return states

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        """Unroll the cell ``length`` steps.

        inputs: Symbol (layout NTC/TNC) or list of per-step Symbols.
        Returns (outputs, final_states); outputs merged to one Symbol
        on the layout's time axis when ``merge_outputs`` is truthy (or
        None with Symbol input), else a list.
        """
        self.reset()
        step_inputs, merge_default = _to_steps(inputs, length, layout)
        if merge_outputs is None:
            merge_outputs = merge_default
        if begin_state is None:
            states = self.begin_state(x=step_inputs[0])
        else:
            states = list(begin_state)
        outputs = []
        for t in range(length):
            out, states = self(step_inputs[t], states)
            outputs.append(out)
        if merge_outputs:
            outputs = _merge_steps(outputs, layout)
        return outputs, states


def _to_steps(inputs, length, layout):
    """Normalize inputs to a list of (batch, feature) step Symbols."""
    if isinstance(inputs, (list, tuple)):
        if len(inputs) != length:
            raise MXNetError("unroll got %d inputs for length %d"
                             % (len(inputs), length))
        return list(inputs), False
    t_axis = layout.find("T")
    if t_axis not in (0, 1):
        raise MXNetError("unsupported RNN layout %s" % layout)
    if length == 1:
        one = sym.slice_axis(inputs, axis=t_axis, begin=0, end=1)
        # drop the singleton time axis: merge it into the batch dim for
        # TNC (axis 0), keep the batch dim for NTC (axis 1)
        shape = (-3, -1) if t_axis == 0 else (0, -1)
        return [sym.Reshape(one, shape=shape)], True
    steps = sym.split(inputs, num_outputs=length, axis=t_axis,
                      squeeze_axis=True)
    return [steps[i] for i in range(length)], True


def _merge_steps(outputs, layout):
    t_axis = layout.find("T")
    return sym.stack(*outputs, axis=t_axis)


# ---------------------------------------------------------------------------
# concrete cells
# ---------------------------------------------------------------------------

class RNNCell(BaseRNNCell):
    """Elman cell: h' = act(x W_i2h + b + h W_h2h + b)."""

    def __init__(self, num_hidden, activation="tanh", prefix="rnn_",
                 params=None):
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._activation = activation
        self._iW = self.params.get("i2h_weight")
        self._iB = self.params.get("i2h_bias")
        self._hW = self.params.get("h2h_weight")
        self._hB = self.params.get("h2h_bias")

    @property
    def state_info(self):
        return [{"shape": (0, self._num_hidden), "__layout__": "NC"}]

    @property
    def _gate_names(self):
        return ("",)

    def __call__(self, inputs, states):
        self._counter += 1
        name = "%st%d_" % (self._prefix, self._counter)
        i2h = sym.FullyConnected(inputs, weight=self._iW, bias=self._iB,
                                 num_hidden=self._num_hidden,
                                 name="%si2h" % name)
        h2h = sym.FullyConnected(states[0], weight=self._hW, bias=self._hB,
                                 num_hidden=self._num_hidden,
                                 name="%sh2h" % name)
        out = sym.Activation(i2h + h2h, act_type=self._activation,
                             name="%sout" % name)
        return out, [out]


class LSTMCell(BaseRNNCell):
    """LSTM cell; gate order (in, forget, cell, out) matches the
    reference so parameters interoperate."""

    def __init__(self, num_hidden, forget_bias=1.0, prefix="lstm_",
                 params=None):
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._forget_bias = forget_bias
        self._iW = self.params.get("i2h_weight")
        self._iB = self.params.get("i2h_bias")
        self._hW = self.params.get("h2h_weight")
        self._hB = self.params.get("h2h_bias")

    @property
    def state_info(self):
        return [{"shape": (0, self._num_hidden), "__layout__": "NC"},
                {"shape": (0, self._num_hidden), "__layout__": "NC"}]

    @property
    def _gate_names(self):
        return ("_i", "_f", "_c", "_o")

    def __call__(self, inputs, states):
        self._counter += 1
        name = "%st%d_" % (self._prefix, self._counter)
        H = self._num_hidden
        i2h = sym.FullyConnected(inputs, weight=self._iW, bias=self._iB,
                                 num_hidden=4 * H, name="%si2h" % name)
        h2h = sym.FullyConnected(states[0], weight=self._hW, bias=self._hB,
                                 num_hidden=4 * H, name="%sh2h" % name)
        gates = i2h + h2h
        g = sym.SliceChannel(gates, num_outputs=4, axis=1,
                             name="%sslice" % name)
        in_gate = sym.sigmoid(g[0])
        forget_gate = sym.sigmoid(g[1] + self._forget_bias)
        in_trans = sym.tanh(g[2])
        out_gate = sym.sigmoid(g[3])
        next_c = forget_gate * states[1] + in_gate * in_trans
        next_h = out_gate * sym.tanh(next_c)
        return next_h, [next_h, next_c]


class GRUCell(BaseRNNCell):
    """GRU cell; gate order (reset, update, new) matches the reference."""

    def __init__(self, num_hidden, prefix="gru_", params=None):
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._iW = self.params.get("i2h_weight")
        self._iB = self.params.get("i2h_bias")
        self._hW = self.params.get("h2h_weight")
        self._hB = self.params.get("h2h_bias")

    @property
    def state_info(self):
        return [{"shape": (0, self._num_hidden), "__layout__": "NC"}]

    @property
    def _gate_names(self):
        return ("_r", "_z", "_o")

    def __call__(self, inputs, states):
        self._counter += 1
        name = "%st%d_" % (self._prefix, self._counter)
        H = self._num_hidden
        i2h = sym.FullyConnected(inputs, weight=self._iW, bias=self._iB,
                                 num_hidden=3 * H, name="%si2h" % name)
        h2h = sym.FullyConnected(states[0], weight=self._hW, bias=self._hB,
                                 num_hidden=3 * H, name="%sh2h" % name)
        ir, iz, io = (x for x in sym.SliceChannel(
            i2h, num_outputs=3, axis=1, name="%si2h_slice" % name))
        hr, hz, ho = (x for x in sym.SliceChannel(
            h2h, num_outputs=3, axis=1, name="%sh2h_slice" % name))
        reset = sym.sigmoid(ir + hr)
        update = sym.sigmoid(iz + hz)
        new = sym.tanh(io + reset * ho)
        next_h = update * states[0] + (1.0 - update) * new
        return next_h, [next_h]


class FusedRNNCell(BaseRNNCell):
    """Whole-sequence fused RNN backed by the ``RNN`` operator (the
    analogue of the reference's cuDNN path, rnn_cell.py FusedRNNCell /
    cudnn_rnn-inl.h)."""

    def __init__(self, num_hidden, num_layers=1, mode="lstm",
                 bidirectional=False, dropout=0.0, get_next_state=False,
                 prefix=None, params=None):
        if prefix is None:
            prefix = "%s_" % mode
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._num_layers = num_layers
        self._mode = mode
        self._bidirectional = bidirectional
        self._dropout = dropout
        self._get_next_state = get_next_state
        self._param = self.params.get("parameters")

    @property
    def state_info(self):
        L = self._num_layers * (2 if self._bidirectional else 1)
        infos = [{"shape": (L, 0, self._num_hidden), "__layout__": "LNC"}]
        if self._mode == "lstm":
            infos.append(dict(infos[0]))
        return infos

    def begin_state(self, func=None, x=None, **kwargs):
        if x is not None:
            # (L, batch, H) zeros derived from a (batch, feature) input
            L = self._num_layers * (2 if self._bidirectional else 1)
            flat = _zeros_like_state(x, self._num_hidden)      # (B, H)
            one = sym.expand_dims(flat, axis=0)                # (1, B, H)
            st = sym.tile(one, reps=(L, 1, 1))
            return [st, st] if self._mode == "lstm" else [st]
        return super().begin_state(func=func, **kwargs)

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        self.reset()
        if isinstance(inputs, (list, tuple)):
            inputs = sym.stack(*inputs, axis=layout.find("T"))
        tnc = inputs if layout == "TNC" else sym.SwapAxis(inputs, dim1=0,
                                                          dim2=1)
        if begin_state is None:
            x0 = _first_step_input(inputs, length, layout)
            begin_state = self.begin_state(x=x0)
        rnn_args = dict(state_size=self._num_hidden,
                        num_layers=self._num_layers,
                        bidirectional=self._bidirectional,
                        mode=self._mode, p=self._dropout,
                        state_outputs=True)
        if self._mode == "lstm":
            out = sym.RNN(tnc, self._param, begin_state[0], begin_state[1],
                          name="%srnn" % self._prefix, **rnn_args)
            outputs, states = out[0], [out[1], out[2]]
        else:
            out = sym.RNN(tnc, self._param, begin_state[0],
                          name="%srnn" % self._prefix, **rnn_args)
            outputs, states = out[0], [out[1]]
        if layout == "NTC":
            outputs = sym.SwapAxis(outputs, dim1=0, dim2=1)
        if merge_outputs is False:
            outputs = [x for x in sym.SliceChannel(
                outputs, num_outputs=length, axis=layout.find("T"),
                squeeze_axis=True)]
        return outputs, (states if self._get_next_state else [])


class SequentialRNNCell(BaseRNNCell):
    """Stack of cells applied in order each step."""

    def __init__(self, params=None):
        super().__init__(prefix="", params=params)
        self._cells = []

    def add(self, cell):
        self._cells.append(cell)

    @property
    def state_info(self):
        return [i for c in self._cells for i in c.state_info]

    def begin_state(self, func=None, x=None, **kwargs):
        states = []
        for c in self._cells:
            states.extend(c.begin_state(func=func, x=x, **kwargs))
        return states

    def _split_states(self, states):
        out = []
        pos = 0
        for c in self._cells:
            n = len(c.state_info)
            out.append(states[pos:pos + n])
            pos += n
        return out

    def __call__(self, inputs, states):
        self._counter += 1
        next_states = []
        for c, s in zip(self._cells, self._split_states(states)):
            inputs, ns = c(inputs, s)
            next_states.extend(ns)
        return inputs, next_states

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        """Layer-major unrolling: each cell consumes the full sequence
        before the next (lets FusedRNNCell members stay fused)."""
        self.reset()
        num = len(self._cells)
        begin = self._split_states(begin_state) if begin_state else \
            [None] * num
        states = []
        for i, c in enumerate(self._cells):
            merge = merge_outputs if i == num - 1 else True
            inputs, s = c.unroll(length, inputs, begin_state=begin[i],
                                 layout=layout, merge_outputs=merge)
            states.extend(s)
        return inputs, states


class BidirectionalCell(BaseRNNCell):
    """Run one cell forward and one backward over the sequence and
    concatenate the step outputs on the feature axis."""

    def __init__(self, l_cell, r_cell, params=None, output_prefix="bi_"):
        super().__init__(prefix="", params=params)
        self._l = l_cell
        self._r = r_cell
        self._output_prefix = output_prefix

    @property
    def state_info(self):
        return self._l.state_info + self._r.state_info

    def begin_state(self, func=None, x=None, **kwargs):
        return self._l.begin_state(func=func, x=x, **kwargs) + \
            self._r.begin_state(func=func, x=x, **kwargs)

    def __call__(self, inputs, states):
        raise MXNetError("BidirectionalCell cannot step; use unroll")

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        self.reset()
        steps, merge_default = _to_steps(inputs, length, layout)
        if merge_outputs is None:
            merge_outputs = merge_default
        nl = len(self._l.state_info)
        bl = begin_state[:nl] if begin_state else None
        br = begin_state[nl:] if begin_state else None
        l_out, l_states = self._l.unroll(length, steps, begin_state=bl,
                                         layout=layout, merge_outputs=False)
        r_out, r_states = self._r.unroll(length, list(reversed(steps)),
                                         begin_state=br, layout=layout,
                                         merge_outputs=False)
        outs = [sym.Concat(lo, ro, dim=1,
                           name="%st%d" % (self._output_prefix, t))
                for t, (lo, ro) in enumerate(zip(l_out,
                                                 reversed(r_out)))]
        if merge_outputs:
            outs = _merge_steps(outs, layout)
        return outs, l_states + r_states


class ModifierCell(BaseRNNCell):
    """Wraps a cell, delegating params/states (reference: ModifierCell)."""

    def __init__(self, base_cell):
        super().__init__(prefix=base_cell._prefix + "mod_", params=None)
        base_cell._modified = True
        self.base_cell = base_cell

    @property
    def params(self):
        return self.base_cell.params

    @property
    def state_info(self):
        return self.base_cell.state_info

    def begin_state(self, func=None, x=None, **kwargs):
        self.base_cell._modified = False
        states = self.base_cell.begin_state(func=func, x=x, **kwargs)
        self.base_cell._modified = True
        return states


class DropoutCell(BaseRNNCell):
    """Dropout on the step output (a cell so it can sit in stacks)."""

    def __init__(self, dropout, prefix="dropout_", params=None):
        super().__init__(prefix=prefix, params=params)
        self._dropout = dropout

    @property
    def state_info(self):
        return []

    def begin_state(self, func=None, x=None, **kwargs):
        return []

    def __call__(self, inputs, states):
        self._counter += 1
        if self._dropout > 0:
            inputs = sym.Dropout(inputs, p=self._dropout,
                                 name="%st%d" % (self._prefix,
                                                 self._counter))
        return inputs, states


class ResidualCell(ModifierCell):
    """Adds the step input to the base cell's output."""

    def __call__(self, inputs, states):
        out, states = self.base_cell(inputs, states)
        return out + inputs, states


class ZoneoutCell(ModifierCell):
    """Zoneout: randomly keep previous states (reference: ZoneoutCell)."""

    def __init__(self, base_cell, zoneout_outputs=0.0, zoneout_states=0.0):
        super().__init__(base_cell)
        self._zo = zoneout_outputs
        self._zs = zoneout_states
        self._prev_output = None

    def reset(self):
        super().reset()
        self._prev_output = None

    def __call__(self, inputs, states):
        out, next_states = self.base_cell(inputs, states)

        def mix(p, new, old):
            if p == 0.0:
                return new
            if old is None:     # first step zones out against zeros
                old = sym.zeros_like(new)
            mask = sym.Dropout(sym.ones_like(new), p=p)
            return sym.where(mask, new, old)

        out_mixed = mix(self._zo, out, self._prev_output)
        self._prev_output = out_mixed       # carry the mixed output
        next_states = [mix(self._zs, n, o)
                       for n, o in zip(next_states, states)]
        return out_mixed, next_states
