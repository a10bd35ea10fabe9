"""Medical image writing, the format from the extension.

Counterpart of ``spine_vision_tpu/io/writers.py``.
"""

from __future__ import annotations

import shutil
import tempfile
from pathlib import Path

from spine_vision_torch.core.logging import logger
from spine_vision_torch.io.metaimage import write_metaimage
from spine_vision_torch.io.nifti import write_nifti
from spine_vision_torch.io.nrrd import write_nrrd
from spine_vision_torch.io.types import MedicalImage


def write_medical_image(
    image: MedicalImage,
    output_path: Path,
    use_compression: bool = True,
) -> None:
    """Write an image; format from extension (.nii/.nii.gz/.mha/.mhd/.nrrd)."""
    output_path = Path(output_path)
    output_path.parent.mkdir(parents=True, exist_ok=True)
    logger.debug("Writing image to: %s", output_path)

    name = output_path.name.lower()
    if name.endswith(".nii") or name.endswith(".nii.gz"):
        write_nifti(image, output_path, compress=use_compression and name.endswith(".gz"))
    elif name.endswith(".mha") or name.endswith(".mhd"):
        write_metaimage(image, output_path, use_compression=use_compression)
    elif name.endswith(".nrrd"):
        write_nrrd(image, output_path, use_compression=use_compression)
    elif name.endswith(".dcm") or not output_path.suffix:
        # Mirrors the read-side convention (readers.detect_format: a
        # directory is a DICOM series): an extensionless target writes one
        # .dcm per slice into that directory; a .dcm target holds a single
        # slice.
        from spine_vision_torch.io.dicom_write import write_dicom_series

        if name.endswith(".dcm"):
            if image.array.ndim == 3 and image.array.shape[0] > 1:
                raise ValueError(
                    "Single .dcm target but multi-slice volume; write to a "
                    "directory (no extension) for a DICOM series"
                )
            # Stage in a temp dir and move once: writing slice_0001.dcm
            # directly into the parent could clobber a pre-existing series
            # slice there.

            with tempfile.TemporaryDirectory(
                dir=output_path.parent
            ) as staging:
                paths = write_dicom_series(image, Path(staging))
                if output_path.exists():
                    logger.warning("Overwriting existing file: %s", output_path)
                shutil.move(str(paths[0]), str(output_path))
        else:
            write_dicom_series(image, output_path)
    else:
        raise ValueError(f"Unsupported output format: {output_path}")


def convert_format(
    input_path: Path,
    output_path: Path,
    use_compression: bool = True,
) -> None:
    """Convert a medical image between formats."""
    from spine_vision_torch.io.readers import read_medical_image

    logger.info("Converting %s -> %s", input_path, output_path)
    image = read_medical_image(Path(input_path))
    write_medical_image(image, Path(output_path), use_compression)
