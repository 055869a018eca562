"""Tree ensembles in QuickScorer layout and their reference scorers."""
