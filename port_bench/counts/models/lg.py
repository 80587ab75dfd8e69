"""The AR(1) linear-Gaussian model (``reference/models/lg.py``): 1 normal a
particle. The update, 6: A x + √Q z (a multiply and a multiply-add: 2); y
− x′ (1); δ², times −1/(2R), plus the row's constant (3)."""
NORMALS = 1
UPDATE_OPS = 6
