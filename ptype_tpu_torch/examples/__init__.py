"""The port's twins of the reference's ``examples/``: the optimus
trainer (``examples.optimus.trainer``, what ``python -m ptype_tpu_torch
train`` runs) and the serving-fleet walkthrough
(``examples.serving.fleet``). They live inside the package so that the
reference's examples, which import ``ptype_tpu``, stay as they are."""
