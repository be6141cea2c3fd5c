"""The port's cluster side: the client interface (``client``), the
in-memory apiserver and gang scheduler the operator runs on (``fake``),
the worker's own-pod annotations (``http_client``), and the chaos drills
of the operator loop, of checkpoints and of the serving fleet
(``chaos``)."""
