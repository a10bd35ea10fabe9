"""Host I/O: medical-image decode and encode, PDF, tabular tables.

Counterpart of ``spine_vision_tpu/io/__init__.py``, with the same names:
DICOM (single files, series assembly, RLE and JPEG Lossless frames), NIfTI-1,
MetaImage (.mha/.mhd) and NRRD, each returning a :class:`MedicalImage` with
ITK-convention geometry; the isotropic middle sagittal slice of a series
(``io/series.py``, its products on the card); CSV label tables without pandas
(``io/tabular.py``). PDF pages are rendered without PyMuPDF (``io/pdf.py``
over ``io/pdf_parse.py``, ``io/pdf_fonts.py`` and ``io/pdf_render.py``).
"""

from spine_vision_torch.io.dicom import read_dicom_file, read_dicom_series
from spine_vision_torch.io.metaimage import read_metaimage, write_metaimage
from spine_vision_torch.io.nifti import read_nifti, write_nifti
from spine_vision_torch.io.nrrd import read_nrrd, write_nrrd
from spine_vision_torch.io.pdf import (
    pdf_first_page_to_array,
    pdf_to_arrays,
    pdf_to_images,
)
from spine_vision_torch.io.readers import ImageFormat, detect_format, read_medical_image
from spine_vision_torch.io.series import (
    extract_isotropic_middle_slice,
    prepare_series_slice,
)
from spine_vision_torch.io.tabular import load_tabular_data, write_records_csv
from spine_vision_torch.io.types import MedicalImage
from spine_vision_torch.io.writers import convert_format, write_medical_image

__all__ = [
    "ImageFormat",
    "MedicalImage",
    "convert_format",
    "detect_format",
    "extract_isotropic_middle_slice",
    "load_tabular_data",
    "pdf_first_page_to_array",
    "pdf_to_arrays",
    "pdf_to_images",
    "prepare_series_slice",
    "read_dicom_file",
    "read_dicom_series",
    "read_medical_image",
    "read_metaimage",
    "read_nifti",
    "read_nrrd",
    "write_medical_image",
    "write_metaimage",
    "write_nifti",
    "write_nrrd",
    "write_records_csv",
]
