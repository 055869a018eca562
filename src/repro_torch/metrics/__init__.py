"""Ranking quality (NDCG) and cost accounting in trees traversed."""
