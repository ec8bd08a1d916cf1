"""Entry points of the port: the CLI verbs (``cli``), the LM server
(``serve``) and its step functions (``steps``)."""
