"""Entry points of the port: the LM server (``serve``) and its step
functions (``steps``)."""
