"""Gluon RNN layers backed by the fused ``RNN`` op (counterpart of
``mxnet_tpu/gluon/rnn/rnn_layer.py``; API of
python/mxnet/gluon/rnn/rnn_layer.py).

The per-layer, per-direction ``i2h``/``h2h`` weights and biases are
Gluon parameters (``l0_i2h_weight`` ...) concatenated into the op's
flat vector at each call, weights first, then biases: the cuDNN layout
``ops/rnn_op.py`` reads. Inside a hybridized block the layer is one
``RNN`` node of the traced graph.
"""
from __future__ import annotations

from ..block import HybridBlock
from ..parameter import DeferredInitializationError
from ... import ndarray as nd

__all__ = ["RNN", "LSTM", "GRU"]


class _RNNLayer(HybridBlock):
    def __init__(self, hidden_size, num_layers, layout, dropout,
                 bidirectional, input_size, i2h_weight_initializer,
                 h2h_weight_initializer, i2h_bias_initializer,
                 h2h_bias_initializer, mode, projection_size=None, **kwargs):
        super().__init__(**kwargs)
        assert layout in ('TNC', 'NTC'), \
            "Invalid layout %s; must be one of ['TNC' or 'NTC']" % layout
        self._hidden_size = hidden_size
        self._projection_size = projection_size
        self._num_layers = num_layers
        self._mode = mode
        self._layout = layout
        self._dropout = dropout
        self._dir = 2 if bidirectional else 1
        self._input_size = input_size
        self._i2h_weight_initializer = i2h_weight_initializer
        self._h2h_weight_initializer = h2h_weight_initializer
        self._i2h_bias_initializer = i2h_bias_initializer
        self._h2h_bias_initializer = h2h_bias_initializer

        self._gates = {'rnn_relu': 1, 'rnn_tanh': 1, 'lstm': 4,
                       'gru': 3}[mode]

        ng, ni, nh = self._gates, input_size, hidden_size
        for i in range(num_layers):
            for j in ['l', 'r'][:self._dir]:
                self._register_param('{}{}_i2h_weight'.format(j, i),
                                     shape=(ng * nh, ni),
                                     init=i2h_weight_initializer)
                self._register_param('{}{}_h2h_weight'.format(j, i),
                                     shape=(ng * nh, nh),
                                     init=h2h_weight_initializer)
                self._register_param('{}{}_i2h_bias'.format(j, i),
                                     shape=(ng * nh,),
                                     init=i2h_bias_initializer)
                self._register_param('{}{}_h2h_bias'.format(j, i),
                                     shape=(ng * nh,),
                                     init=h2h_bias_initializer)
            ni = nh * self._dir

    def _register_param(self, name, shape, init):
        p = self.params.get(name, shape=shape, init=init,
                            allow_deferred_init=True)
        setattr(self, name, p)
        return p

    def __repr__(self):
        s = '{name}({mapping}, {_layout}'
        if self._num_layers != 1:
            s += ', num_layers={_num_layers}'
        if self._dropout != 0:
            s += ', dropout={_dropout}'
        if self._dir == 2:
            s += ', bidirectional'
        s += ')'
        shape = getattr(self, "l0_i2h_weight").shape
        mapping = '{0} -> {1}'.format(
            shape[1] if shape[1] else None, shape[0] // self._gates)
        return s.format(name=self.__class__.__name__, mapping=mapping,
                        **self.__dict__)

    def state_info(self, batch_size=0):
        raise NotImplementedError

    def infer_shape(self, *args):
        """Layer-owned param-shape inference: the reference gets this from
        NNVM's bidirectional shape pass through _rnn_param_concat; here
        the layer computes it directly from the input feature dim."""
        x = args[0]
        ni = x.shape[2]  # feature dim is last in both TNC and NTC
        ng, nh = self._gates, self._hidden_size
        for i in range(self._num_layers):
            for j in ['l', 'r'][:self._dir]:
                getattr(self, '{}{}_i2h_weight'.format(j, i))._shape = \
                    (ng * nh, ni)
            ni = nh * self._dir
        for p in self.collect_params().values():
            p._finish_deferred_init()

    def forward(self, inputs, states=None):
        """Called alone, the layer runs its one ``RNN`` op eagerly (a
        hybridized parent block traces it into its graph)."""
        from ...ndarray import NDArray
        from ... import symbol as sym_mod
        if isinstance(inputs, NDArray):
            try:
                kwargs = {i: j.data() for i, j in self._reg_params.items()}
            except DeferredInitializationError:
                self.infer_shape(inputs)
                kwargs = {i: j.data() for i, j in self._reg_params.items()}
            return self.hybrid_forward(nd, inputs, states, **kwargs)
        params = {i: j.var() for i, j in self._reg_params.items()}
        with self.name_scope():
            return self.hybrid_forward(sym_mod, inputs, states, **params)

    def begin_state(self, batch_size=0, func=nd.zeros, **kwargs):
        """Initial recurrent states (reference: rnn_layer.py:163)."""
        states = []
        kwargs.pop('name', None)
        for i, info in enumerate(self.state_info(batch_size)):
            shape = info['shape']
            ctx = kwargs.get('ctx', None)
            dtype = kwargs.get('dtype', 'float32')
            states.append(func(shape, ctx=ctx, dtype=dtype))
        return states

    def hybrid_forward(self, F, inputs, states=None, **kwargs):
        if self._layout == 'NTC':
            inputs = F.SwapAxis(inputs, dim1=0, dim2=1)
        batch_size = inputs.shape[1] if hasattr(inputs, "shape") else 0
        skip_states = states is None
        if skip_states:
            states = self.begin_state(batch_size,
                                      ctx=getattr(inputs, "context", None))
        if isinstance(states, (nd.NDArray,)) or (
                not isinstance(states, (list, tuple))):
            states = [states]
        out = self._forward_kernel(F, inputs, states, **kwargs)
        outputs, states = out[0], out[1:]
        if self._layout == 'NTC':
            outputs = F.SwapAxis(outputs, dim1=0, dim2=1)
        if skip_states:
            return outputs
        return outputs, list(states)

    def _forward_kernel(self, F, inputs, states, **kwargs):
        params = []
        # flat parameter vector: weights then biases (fused-op layout)
        for t in ['weight', 'bias']:
            for i in range(self._num_layers):
                for j in ['l', 'r'][:self._dir]:
                    for g in ['i2h', 'h2h']:
                        p = kwargs['{}{}_{}_{}'.format(j, i, g, t)]
                        params.append(p.reshape(-1))
        params = F.Concat(*params, dim=0) if len(params) > 1 else params[0]

        tensors = [inputs, params] + list(states)
        rnn_out = F.RNN(*tensors, state_size=self._hidden_size,
                        num_layers=self._num_layers,
                        bidirectional=self._dir == 2,
                        p=self._dropout, state_outputs=True,
                        mode=self._mode)
        # state_outputs: an output list from nd, one Symbol of 2-3
        # outputs from sym (split here, as the JAX layer does not)
        return list(rnn_out)


def _fn_args(func):
    import inspect
    try:
        return inspect.signature(func).parameters
    except (TypeError, ValueError):
        return {}


class RNN(_RNNLayer):
    """Vanilla RNN layer (reference: rnn_layer.py:253)."""

    def __init__(self, hidden_size, num_layers=1, activation='relu',
                 layout='TNC', dropout=0, bidirectional=False,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer='zeros', h2h_bias_initializer='zeros',
                 input_size=0, **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size,
                         i2h_weight_initializer, h2h_weight_initializer,
                         i2h_bias_initializer, h2h_bias_initializer,
                         'rnn_' + activation, **kwargs)

    def state_info(self, batch_size=0):
        return [{'shape': (self._num_layers * self._dir, batch_size,
                           self._hidden_size), '__layout__': 'LNC'}]


class LSTM(_RNNLayer):
    """LSTM layer (reference: rnn_layer.py:356)."""

    def __init__(self, hidden_size, num_layers=1, layout='TNC', dropout=0,
                 bidirectional=False, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer='zeros', h2h_bias_initializer='zeros',
                 projection_size=None, **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size,
                         i2h_weight_initializer, h2h_weight_initializer,
                         i2h_bias_initializer, h2h_bias_initializer,
                         'lstm', projection_size, **kwargs)

    def state_info(self, batch_size=0):
        return [{'shape': (self._num_layers * self._dir, batch_size,
                           self._hidden_size), '__layout__': 'LNC'},
                {'shape': (self._num_layers * self._dir, batch_size,
                           self._hidden_size), '__layout__': 'LNC'}]


class GRU(_RNNLayer):
    """GRU layer (reference: rnn_layer.py:476)."""

    def __init__(self, hidden_size, num_layers=1, layout='TNC', dropout=0,
                 bidirectional=False, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer='zeros', h2h_bias_initializer='zeros',
                 **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size,
                         i2h_weight_initializer, h2h_weight_initializer,
                         i2h_bias_initializer, h2h_bias_initializer,
                         'gru', **kwargs)

    def state_info(self, batch_size=0):
        return [{'shape': (self._num_layers * self._dir, batch_size,
                           self._hidden_size), '__layout__': 'LNC'}]
