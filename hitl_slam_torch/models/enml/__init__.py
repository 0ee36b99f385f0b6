"""Episodic non-Markov Localization: the batch SLAM front end."""
