"""UC-SV (``reference/models/ucsv.py``): 3 normals a particle (x, log σε,
log ση). The update, 14: x + exp(½ log σε) z0 (the ½, the exp's scale and
ex2, a multiply-add: 4); log σε + γε z1 and log ση + γη z2 (a multiply-add
each: 2); exp(−½ log ση) (3); (y − x′) times it (2); −½ z² − ½ log ση − c
(the square, then two multiply-adds: 3)."""
NORMALS = 3
UPDATE_OPS = 14
