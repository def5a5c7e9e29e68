"""Entry points of the language-model substrate (``launch.serve``)."""
