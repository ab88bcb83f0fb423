"""The optimus trainer of the port (``trainer.main``)."""
