"""The kubebench reporter, configurator and runner (``kubebench``)."""
