"""The serving-fleet walkthrough of the port (``fleet.main``)."""
