"""The paper's own four evaluation models (§4.1) as configs, so scripts
can select them by id (mirrors ``repro/configs/paper_models.py``).  They
are the small models of `models.smallnets`, kept apart from the LLM
registry."""
from ..models.smallnets import make_smallnet

PAPER_MODELS = {
    "paper-mnist-cnn": dict(name="mnist_cnn"),
    "paper-fmnist-cnn": dict(name="fmnist_cnn"),
    "paper-imdb-lstm": dict(name="imdb_lstm"),
    "paper-reuters-dnn": dict(name="reuters_dnn"),
}


def make_paper_model(arch_id: str, **kw):
    spec = dict(PAPER_MODELS[arch_id])
    spec.update(kw)
    return make_smallnet(spec.pop("name"), **spec)
