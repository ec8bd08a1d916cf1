"""Entry points of the port: the CLI verbs (``cli``), the LM trainer
(``train``), the LM server (``serve``) and their step functions
(``steps``)."""
