"""Modules of the model: layers, Backbone, ConvLSTMCell, BINPyramid and the
sliding-window driver."""
