"""How the benchmark builds the program for a configuration. A
configuration's ``program`` key names the module here
(``harness.port_config``); its ``config(conf)`` returns the program's
model configuration and ``SparKVConfig`` from the configuration file's
``name``, ``model`` and ``sparkv`` blocks."""
