"""State/input dimensions (car_racing_tpu/utils/constants.py).

- curvilinear state ``xcurv = [vx, vy, wz, epsi, s, ey]``
- global state      ``xglob = [vx, vy, wz, psi, X, Y]``
- input             ``u = [delta (steering), a (acceleration)]``
"""

X_DIM = 6
U_DIM = 2
