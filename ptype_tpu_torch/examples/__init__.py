"""The port's twins of the reference's ``examples/``: the optimus trainer
(``examples.optimus.trainer``, what ``python -m ptype_tpu_torch train``
runs) and the scatter-gather walkthrough (``examples.optimus.worker`` and
``coordinator``), the calculator (``examples.calculator``), the
serving-fleet walkthrough (``examples.serving.fleet``) and the three
observability walkthroughs (``examples.observability``). They live
inside the package so that the reference's examples, which import
``ptype_tpu``, stay as they are."""
