"""The canonical stochastic-volatility model (``reference/models/sv.py``):
1 normal a particle. The update, 8: mu + phi (x − mu) + sigma z (a
difference and two multiply-adds: 3); exp(−x′) (the scale and the ex2: 2);
times the row's −½ y² (1); −½ x′ − c (a multiply-add: 1); their sum (1)."""
NORMALS = 1
UPDATE_OPS = 8
