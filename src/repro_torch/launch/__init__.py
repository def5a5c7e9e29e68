"""Entry points of the language-model substrate (``launch.serve``,
``launch.train``) and the train step they share (``launch.steps``)."""
