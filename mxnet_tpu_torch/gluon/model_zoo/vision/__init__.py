"""Model zoo vision namespace (counterpart of
``mxnet_tpu/gluon/model_zoo/vision``): the ResNets, v1 and v2 at 18,
34, 50, 101 and 152 layers, and ``get_model``. The other families (VGG,
AlexNet, DenseNet, SqueezeNet, Inception, MobileNet) wait for their ops
(ROADMAP queue A item 9)."""
from .resnet import *  # noqa: F401,F403
from . import resnet


def get_model(name, **kwargs):
    """Factory by name (reference: vision/__init__.py get_model)."""
    models = {
        'resnet18_v1': resnet18_v1, 'resnet34_v1': resnet34_v1,
        'resnet50_v1': resnet50_v1, 'resnet101_v1': resnet101_v1,
        'resnet152_v1': resnet152_v1,
        'resnet18_v2': resnet18_v2, 'resnet34_v2': resnet34_v2,
        'resnet50_v2': resnet50_v2, 'resnet101_v2': resnet101_v2,
        'resnet152_v2': resnet152_v2,
    }
    name = name.lower()
    if name not in models:
        raise ValueError(
            'Model %s is not supported. Available options are\n\t%s' % (
                name, '\n\t'.join(sorted(models.keys()))))
    return models[name](**kwargs)
