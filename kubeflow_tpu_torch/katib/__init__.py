"""The port's Katib client: the worker's trial-observation reporter
(``vizier``) and the random suggestion engine of kubebench's in-process
study (``suggestion``)."""
