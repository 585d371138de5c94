"""Show and analyse a stored parameter study (counterpart of
``nsol_tpu/cli/show_parameter_study.py``; reference:
nsol/application/show_parameter_study.py:29-386).

The L-curve of the last (Data, Reg) of each configuration with an arrow
towards increasing α, the measures against the iteration (with the
synthesized ``Cost = Data + α·Reg`` when α alone varies), and the
reconstructions: a 2-D gallery, or each 3-D volume's orthogonal central
slices with its voxel spacing and the reference mask's contour, or, with
``--interactive``, the volumes in ITK-Snap or napari where installed
(:mod:`nsol_tpu_torch.viewer`). The study is read through
:class:`~nsol_tpu_torch.study.ReaderParameterStudy`, so a study written by
either package shows the same. The figures are drawn with matplotlib's Agg
backend; matplotlib is imported by the functions that draw, not by the
module.

    nsol_torch_show_parameter_study --dir-input DIR --study-name NAME \
        --dir-output-figures FIGS
"""

import os
import re

import numpy as np

from nsol_tpu_torch import timer as ph
from nsol_tpu_torch.cli.argparser import InputArgparser
from nsol_tpu_torch.io import DataReader
from nsol_tpu_torch.study import ReaderParameterStudy

LINESTYLES = ["-", ":", "--", "-."]
MARKERS = ["o", "s", "v", "x", "p", "*", "D", "^", "<", ">", "h", "+"]


def _is_float(s):
    try:
        float(s)
        return True
    except (TypeError, ValueError):
        return False


def _pyplot():
    """matplotlib's pyplot on the Agg backend."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def show_L_curve(reader, lines, dir_output=None):
    plt = _pyplot()
    name = reader.get_parameter_study_name()
    labels_dic = reader.get_line_to_parameter_labels()
    nda_data = np.atleast_2d(reader.get_results("Data"))
    nda_reg = np.atleast_2d(reader.get_results("Reg"))

    labels, x, y = [], [], []
    for line in lines:
        labels.extend([labels_dic[i] for i in line])
        x.extend([nda_data[i, -1] for i in line])
        y.extend([nda_reg[i, -1] for i in line])

    fig = plt.figure("L-curve")
    fig.clf()
    plt.plot(x, y, color="lightgrey")
    if len(x) > 1:
        plt.annotate("", xytext=(x[0], y[0]), xy=(x[1], y[1]),
                     arrowprops=dict(arrowstyle="->", color="lightgrey"),
                     size=20)
    markers = MARKERS * 100
    for c in range(len(y)):
        plt.plot(x[c], y[c], label=labels[c], marker=markers[c],
                 linestyle=LINESTYLES[c % len(LINESTYLES)])
    plt.legend(loc="best", shadow=False, frameon=True)
    plt.grid(True, which="major", ls="-", color="0.8")
    plt.xlabel(r"Data $\Phi(x)$")
    plt.ylabel(r"Regularizer $\Psi(x)$")
    plt.title("%s: L-curve" % name)
    if dir_output is not None:
        os.makedirs(dir_output, exist_ok=True)
        fig.savefig(os.path.join(dir_output, "%s_L-curve.pdf" % name))
    plt.close(fig)


def show_measures(reader, lines, dir_output=None):
    plt = _pyplot()
    from matplotlib.ticker import MaxNLocator

    name = reader.get_parameter_study_name()
    labels_dic = reader.get_line_to_parameter_labels()
    measures = list(reader.get_measures())

    # Synthesize total cost when only alpha varies (reference :122-126)
    params = reader.get_parameters()
    if (len(params) == 1 and "alpha" in params
            and "Data" in measures and "Reg" in measures):
        measures.insert(0, "Cost")

    markers = MARKERS * 100
    for m in measures:
        y, labels = [], []
        for line in lines:
            labels.extend([labels_dic[i] for i in line])
            if m == "Cost":
                nda_data = np.atleast_2d(reader.get_results("Data"))
                nda_reg = np.atleast_2d(reader.get_results("Reg"))
                alphas_str = [re.sub("alpha=", "", lab) for lab in labels]
                if any(not _is_float(a) for a in alphas_str):
                    raise RuntimeError(
                        "Cannot synthesize the total cost: a swept alpha "
                        "label is not numeric")
                alphas = np.array([float(a) for a in alphas_str]
                                  ).reshape(-1, 1)
                nda = nda_data + alphas * nda_reg
            else:
                nda = np.atleast_2d(reader.get_results(m))
            y.extend([nda[i, :] for i in line])

        markevery = 1 if len(y[0]) < 10 else 5
        fig = plt.figure(m)
        fig.clf()
        ax = fig.gca()
        x = np.arange(len(y[-1]))
        for c in range(len(y)):
            plt.plot(x, y[c], label=labels[c], marker=markers[c],
                     linestyle=LINESTYLES[c % len(LINESTYLES)],
                     markevery=markevery)
        ax.xaxis.set_major_locator(MaxNLocator(integer=True))
        if m == "Data":
            m_label, scale = r"Data $\Phi(x)$", "log"
        elif m == "Reg":
            m_label, scale = r"Regularizer $\Psi(x)$", "log"
        elif m == "Cost":
            m_label, scale = r"Total Cost $\Phi(x) + \alpha\,\Psi(x)$", "log"
        else:
            m_label, scale = m, "linear"
        plt.yscale(scale)
        plt.legend(loc="best", shadow=False, frameon=True)
        plt.grid(True, which="major", ls="-", color="0.8")
        plt.xlabel("iteration")
        plt.title("%s: %s" % (name, m_label))
        if dir_output is not None:
            os.makedirs(dir_output, exist_ok=True)
            fig.savefig(os.path.join(dir_output, "%s_%s.pdf" % (name, m)))
        plt.close(fig)


def show_reconstructions(reader, lines, dir_output=None,
                         colormap="Greys_r", reference=None,
                         reference_mask=None, interactive=False):
    plt = _pyplot()
    try:
        recon_dic = reader.get_reconstructions()
    except IOError as e:
        print("Error: '%s'. Visualization skipped." % e)
        return

    ph.print_info("Prepare comparison of reconstructions ... ")
    name = reader.get_parameter_study_name()
    labels_dic = reader.get_line_to_parameter_labels()
    shape = tuple(int(s) for s in recon_dic["shape"])

    # Segmentation overlay for 3-D galleries (reference contract:
    # show_parameter_study.py:296-313 hands the mask to the 3-D viewer as
    # a segmentation over every reconstruction; 2-D studies ignore it).
    mask_nda = None
    if reference_mask is not None and len(shape) == 3:
        rd = DataReader(reference_mask)
        rd.read_data()
        mask_nda = np.asarray(rd.get_data())
        if mask_nda.shape != shape:
            raise IOError(
                "Reference mask shape %s does not match the reconstruction "
                "geometry %s" % (mask_nda.shape, shape))
    # Optional spatial metadata persisted by the study CLIs for nii inputs
    # (reference contract: show_parameter_study.py:279-291 feeds
    # origin/spacing/direction to the 3-D viewer). Spacing is (x, y, z).
    if "spacing" in recon_dic:
        spacing = np.asarray(recon_dic["spacing"], dtype=np.float64)
    else:
        spacing = np.ones(len(shape))

    for j, line in enumerate(lines):
        labels = [labels_dic[i] for i in line]
        data_nda = [np.asarray(recon_dic[str(i)], dtype=np.float32).reshape(
            shape) for i in line]
        if reference is not None:
            rd = DataReader(reference)
            rd.read_data()
            data_nda.insert(0, rd.get_data())
            labels.insert(0, "Reference")

        if len(shape) == 2:
            n = len(data_nda)
            fig, axes = plt.subplots(1, n, figsize=(4 * n, 4))
            axes = np.atleast_1d(axes)
            vmin = min(d.min() for d in data_nda)
            vmax = max(d.max() for d in data_nda)
            for ax, d, lab in zip(axes, data_nda, labels):
                ax.imshow(d, cmap=colormap, vmin=vmin, vmax=vmax)
                ax.set_title(lab, fontsize=8)
                ax.axis("off")
            if dir_output is not None:
                os.makedirs(dir_output, exist_ok=True)
                suffix = ("_reconstructions.pdf" if len(lines) == 1
                          else "_reconstructions_%d.pdf" % (j + 1))
                fig.savefig(os.path.join(dir_output, name + suffix))
            plt.close(fig)
        elif len(shape) == 3:
            if interactive:
                # reference contract: hand all reconstructions (+ mask
                # as segmentation, + spacing) to the interactive viewer
                # (show_parameter_study.py:279-313); headless gallery
                # below is the fallback when none is installed
                from nsol_tpu_torch.viewer import try_interactive_3d

                if try_interactive_3d(data_nda, labels, spacing=spacing,
                                      segmentation=mask_nda):
                    continue
                print("No interactive 3-D viewer (itksnap/napari) "
                      "available; rendering the headless gallery.")
            # Headless 3-D gallery: orthogonal central slices per recon,
            # with voxel spacing applied as per-plane aspect ratios so
            # anisotropic volumes display spatially correct. Arrays are
            # (z, y, x); spacing is (x, y, z).
            sx, sy, sz = spacing[0], spacing[1], spacing[2]
            for d, lab in zip(data_nda, labels):
                fig, axes = plt.subplots(1, 3, figsize=(12, 4))
                mid = [s // 2 for s in shape]
                axes[0].imshow(d[mid[0]], cmap=colormap, aspect=sy / sx)
                axes[1].imshow(d[:, mid[1]], cmap=colormap, aspect=sz / sx)
                axes[2].imshow(d[:, :, mid[2]], cmap=colormap,
                               aspect=sz / sy)
                if mask_nda is not None:
                    slices = (mask_nda[mid[0]], mask_nda[:, mid[1]],
                              mask_nda[:, :, mid[2]])
                    for ax, ms in zip(axes, slices):
                        if ms.max() > ms.min():
                            ax.contour(ms, levels=[0.5 * (ms.max()
                                                          + ms.min())],
                                       colors="red", linewidths=0.8)
                for ax in axes:
                    ax.axis("off")
                fig.suptitle("%s: %s" % (name, lab))
                if dir_output is not None:
                    os.makedirs(dir_output, exist_ok=True)
                    safe = re.sub(r"[^A-Za-z0-9_=+-]", "p", lab)
                    fig.savefig(os.path.join(
                        dir_output, "%s_recon_%s.pdf" % (name, safe)))
                plt.close(fig)


def main(argv=None):
    input_parser = InputArgparser(
        description="Show and analyse stored parameter study.")
    input_parser.add_dir_input(required=True)
    input_parser.add_study_name(required=True)
    input_parser.add_dir_output_figures()
    input_parser.add_colormap(default="Greys_r")
    input_parser.add_reference()
    input_parser.add_option(option_string="--reference-mask", type=str)
    input_parser.add_option(
        option_string="--show-reconstructions", type=int, default=1,
        help="Turn on/off visualization of reconstructions")
    input_parser.add_option(
        option_string="--interactive", type=int, default=0,
        help="Open 3-D reconstructions in an interactive viewer "
             "(itksnap or napari, if installed) instead of the "
             "headless slice gallery")
    args = input_parser.parse_args(argv)
    input_parser.print_arguments(args)

    reader = ReaderParameterStudy(directory=args.dir_input,
                                  name=args.study_name)
    reader.read_study()
    parameters_dic = reader.get_parameters()

    # Slices of the grid where only alpha varies (reference :351-369)
    lines = []
    if len(parameters_dic) == 1:
        lines.append(reader.get_lines_to_parameters(parameters_dic))
    else:
        for k in parameters_dic:
            if k == "alpha":
                continue
            for val in parameters_dic[k]:
                p = {"alpha": parameters_dic["alpha"], k: val}
                # include remaining fixed keys
                for other in parameters_dic:
                    if other not in p:
                        p[other] = parameters_dic[other][0]
                lines.append(reader.get_lines_to_parameters(p))

    show_L_curve(reader, lines, args.dir_output_figures)
    show_measures(reader, lines, args.dir_output_figures)
    if args.show_reconstructions:
        show_reconstructions(reader, lines, args.dir_output_figures,
                             colormap=args.colormap,
                             reference=args.reference,
                             reference_mask=args.reference_mask,
                             interactive=bool(args.interactive))
    return 0


if __name__ == "__main__":
    main()
