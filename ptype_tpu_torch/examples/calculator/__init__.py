"""The calculator walkthrough of the port: the ``Calculator`` actor, its
server and its client (``server.main``, ``client.main``)."""
