"""The port's cluster side: the client interface (``client``), the
in-memory apiserver and gang scheduler the operator runs on (``fake``),
the REST wire format (``wire``), the HTTP apiserver over any client
(``apiserver``) and the HTTP client of the manager process and of the
worker's own-pod annotations (``http_client``), leader election over
Lease objects with its fenced client (``lease``), and the chaos drills
of the operator loop, of the controllers themselves, of checkpoints and
of the serving fleet (``chaos``)."""
