"""Convolutional RNN cells (counterpart of
``mxnet_tpu/gluon/contrib/rnn/conv_rnn_cell.py``; API of
python/mxnet/gluon/contrib/rnn/conv_rnn_cell.py).

One ``_ConvGateCell`` base owns the i2h/h2h convolution parameters and
the state's spatial shape for every dimensionality; the RNN/LSTM/GRU
gate arithmetic comes from a mixin's ``hybrid_forward``, and the nine
public classes bind a mixin to a dimensionality. The convolutions are
the ``Convolution`` op (cuDNN through torch on the card), as the JAX
package computes them with ``lax.conv_general_dilated``: no hand
kernel lies on this path.
"""
from __future__ import annotations

from ....base import MXNetError
from ...rnn.rnn_cell import HybridRecurrentCell

__all__ = ["Conv1DRNNCell", "Conv2DRNNCell", "Conv3DRNNCell",
           "Conv1DLSTMCell", "Conv2DLSTMCell", "Conv3DLSTMCell",
           "Conv1DGRUCell", "Conv2DGRUCell", "Conv3DGRUCell"]

_LAYOUTS = {1: "NCW", 2: "NCHW", 3: "NCDHW"}


def _tuplize(v, n, name):
    if isinstance(v, int):
        return (v,) * n
    v = tuple(v)
    if len(v) != n:
        raise MXNetError("%s must have %d elements, got %s"
                         % (name, n, (v,)))
    return v


class _ConvGateCell(HybridRecurrentCell):
    """Gate cell whose projections are N-D convolutions. ``h2h`` pads
    to keep the state's spatial dims fixed; the ``i2h`` geometry sets
    the state's resolution from the input's."""

    _GATES = 1

    def __init__(self, input_shape, hidden_channels, i2h_kernel,
                 h2h_kernel, i2h_pad, i2h_dilate, h2h_dilate,
                 activation, prefix, params, dims, conv_layout,
                 i2h_weight_initializer=None,
                 h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros"):
        super().__init__(prefix=prefix, params=params)
        default_layout = _LAYOUTS[dims]
        if conv_layout not in (None, default_layout):
            raise MXNetError(
                "conv_layout %r is not supported (channel-first %s "
                "only)" % (conv_layout, default_layout))
        self._conv_layout = default_layout
        self._dims = dims
        self._input_shape = tuple(input_shape)   # (C, *spatial)
        self._hidden_channels = hidden_channels
        self._activation = activation
        self._i2h_kernel = _tuplize(i2h_kernel, dims, "i2h_kernel")
        self._h2h_kernel = _tuplize(h2h_kernel, dims, "h2h_kernel")
        for k in self._h2h_kernel:
            if k % 2 == 0:
                raise MXNetError(
                    "h2h_kernel must be odd so the state keeps its "
                    "spatial shape; got %s" % (self._h2h_kernel,))
        self._i2h_pad = _tuplize(i2h_pad, dims, "i2h_pad")
        self._i2h_dilate = _tuplize(i2h_dilate, dims, "i2h_dilate")
        self._h2h_dilate = _tuplize(h2h_dilate, dims, "h2h_dilate")
        self._h2h_pad = tuple(d * (k - 1) // 2 for k, d in
                              zip(self._h2h_kernel, self._h2h_dilate))
        c_in = self._input_shape[0]
        self._state_spatial = tuple(
            s + 2 * p - d * (k - 1)
            for s, p, d, k in zip(self._input_shape[1:], self._i2h_pad,
                                  self._i2h_dilate, self._i2h_kernel))
        width = self._GATES * hidden_channels
        self.i2h_weight = self.params.get(
            "i2h_weight", shape=(width, c_in) + self._i2h_kernel,
            init=i2h_weight_initializer, allow_deferred_init=True)
        self.h2h_weight = self.params.get(
            "h2h_weight",
            shape=(width, hidden_channels) + self._h2h_kernel,
            init=h2h_weight_initializer, allow_deferred_init=True)
        self.i2h_bias = self.params.get(
            "i2h_bias", shape=(width,), init=i2h_bias_initializer,
            allow_deferred_init=True)
        self.h2h_bias = self.params.get(
            "h2h_bias", shape=(width,), init=h2h_bias_initializer,
            allow_deferred_init=True)

    def _one_state_info(self, batch_size):
        shape = (batch_size, self._hidden_channels) + self._state_spatial
        return {"shape": shape, "__layout__": self._conv_layout}

    def state_info(self, batch_size=0):
        return [self._one_state_info(batch_size)]

    def _projections(self, F, inputs, state_h, i2h_weight, h2h_weight,
                     i2h_bias, h2h_bias, tag):
        width = self._GATES * self._hidden_channels
        i2h = F.Convolution(inputs, i2h_weight, i2h_bias,
                            kernel=self._i2h_kernel, num_filter=width,
                            pad=self._i2h_pad, dilate=self._i2h_dilate,
                            name=tag + "i2h")
        h2h = F.Convolution(state_h, h2h_weight, h2h_bias,
                            kernel=self._h2h_kernel, num_filter=width,
                            pad=self._h2h_pad, dilate=self._h2h_dilate,
                            name=tag + "h2h")
        return i2h, h2h

    def _act(self, F, x, name):
        return self._get_activation(F, x, self._activation, name=name)


class _ConvRNNMixin:
    _GATES = 1

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        tag = "t%d_" % self._counter
        i2h, h2h = self._projections(F, inputs, states[0], i2h_weight,
                                     h2h_weight, i2h_bias, h2h_bias, tag)
        out = self._act(F, i2h + h2h, tag + "out")
        return out, [out]


class _ConvLSTMMixin:
    _GATES = 4

    def state_info(self, batch_size=0):
        one = self._one_state_info(batch_size)
        return [one, dict(one)]

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        tag = "t%d_" % self._counter
        i2h, h2h = self._projections(F, inputs, states[0], i2h_weight,
                                     h2h_weight, i2h_bias, h2h_bias, tag)
        pieces = F.SliceChannel(i2h + h2h, num_outputs=4, axis=1,
                                name=tag + "slice")
        gate_in = F.sigmoid(pieces[0])
        gate_forget = F.sigmoid(pieces[1])
        candidate = self._act(F, pieces[2], tag + "c")
        gate_out = F.sigmoid(pieces[3])
        next_c = gate_forget * states[1] + gate_in * candidate
        next_h = gate_out * self._act(F, next_c, tag + "state")
        return next_h, [next_h, next_c]


class _ConvGRUMixin:
    _GATES = 3

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        tag = "t%d_" % self._counter
        i2h, h2h = self._projections(F, inputs, states[0], i2h_weight,
                                     h2h_weight, i2h_bias, h2h_bias, tag)
        ir, iz, ih = F.SliceChannel(i2h, num_outputs=3, axis=1,
                                    name=tag + "i2h_slice")
        hr, hz, hh = F.SliceChannel(h2h, num_outputs=3, axis=1,
                                    name=tag + "h2h_slice")
        reset = F.sigmoid(ir + hr)
        update = F.sigmoid(iz + hz)
        candidate = self._act(F, ih + reset * hh, tag + "h_act")
        next_h = (1.0 - update) * candidate + update * states[0]
        return next_h, [next_h]


def _make(mixin, dims, kind):
    class Cell(mixin, _ConvGateCell):
        def __init__(self, input_shape, hidden_channels, i2h_kernel,
                     h2h_kernel, i2h_pad=0, i2h_dilate=1, h2h_dilate=1,
                     i2h_weight_initializer=None,
                     h2h_weight_initializer=None,
                     i2h_bias_initializer="zeros",
                     h2h_bias_initializer="zeros",
                     conv_layout=None, activation="tanh",
                     prefix=None, params=None):
            _ConvGateCell.__init__(
                self, input_shape, hidden_channels, i2h_kernel,
                h2h_kernel, i2h_pad, i2h_dilate, h2h_dilate,
                activation, prefix, params, dims, conv_layout,
                i2h_weight_initializer=i2h_weight_initializer,
                h2h_weight_initializer=h2h_weight_initializer,
                i2h_bias_initializer=i2h_bias_initializer,
                h2h_bias_initializer=h2h_bias_initializer)

        def _alias(self):
            return "conv%s" % kind

    Cell.__name__ = Cell.__qualname__ = "Conv%dD%sCell" % (dims,
                                                          kind.upper())
    return Cell


Conv1DRNNCell = _make(_ConvRNNMixin, 1, "rnn")
Conv2DRNNCell = _make(_ConvRNNMixin, 2, "rnn")
Conv3DRNNCell = _make(_ConvRNNMixin, 3, "rnn")
Conv1DLSTMCell = _make(_ConvLSTMMixin, 1, "lstm")
Conv2DLSTMCell = _make(_ConvLSTMMixin, 2, "lstm")
Conv3DLSTMCell = _make(_ConvLSTMMixin, 3, "lstm")
Conv1DGRUCell = _make(_ConvGRUMixin, 1, "gru")
Conv2DGRUCell = _make(_ConvGRUMixin, 2, "gru")
Conv3DGRUCell = _make(_ConvGRUMixin, 3, "gru")
