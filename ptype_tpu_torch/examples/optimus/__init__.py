"""The optimus examples of the port: the trainer (``trainer.main``) and
the scatter-gather walkthrough — the ``Prime`` actor, its worker and
the HTTP coordinator that fans a factor search over the workers
(``worker.main``, ``coordinator.main``)."""
