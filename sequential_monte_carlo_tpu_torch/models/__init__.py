from .ucsv import UCSVModel, ucsv_model, ucsv_update

__all__ = ["UCSVModel", "ucsv_model", "ucsv_update"]
