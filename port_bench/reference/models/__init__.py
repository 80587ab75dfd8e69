"""The plain models, one module a model, found by the configuration's
``model`` name (``catalog.load_module("reference/models", name)``)."""
