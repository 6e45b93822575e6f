"""The port's learning layer: the model container and its wire envelopes,
callbacks, the learner, the aggregators, loss, optimizer and data."""
