"""Physical constants and unit conversions.

Values follow CODATA-2014 (the same vintage PySCF's ``pyscf.data.nist`` uses)
so that energies/geometries round-trip against CPU PySCF references. The
reference templates additionally hard-code a few rounded constants
(627.509 Ha->kcal/mol, 27.2114 Ha->eV, 1239.84198 eV*nm, 42.2561 km/mol IR
prefactor — see reference templates/calculate_energy.py and opt-freq.py); we
expose the precise values and keep the workflow-layer output format identical.
"""

# Length
BOHR = 0.52917721092          # Angstrom per Bohr
ANG2BOHR = 1.0 / BOHR
BOHR_SI = 0.52917721092e-10   # m

# Energy
HARTREE2EV = 27.211386024367243
HARTREE2KCAL = 627.5094740631
HARTREE2KJ = 2625.4996394799
HARTREE2WAVENUMBER = 219474.63136320   # cm^-1
HARTREE2J = 4.359744650e-18
EV2NM = 1239.841984                    # lambda[nm] = EV2NM / E[eV]

# Thermo
KB_SI = 1.380648520e-23        # J/K
KB_HARTREE = KB_SI / HARTREE2J  # Ha/K
AVOGADRO = 6.022140857e23
PLANCK_SI = 6.626070040e-34    # J*s
R_GAS_SI = KB_SI * AVOGADRO    # J/(mol*K)
ATM2PA = 101325.0
AMU2KG = 1.660539040e-27
AMU2AU = 1822.888486192        # electron masses per amu
LIGHT_SPEED_SI = 299792458.0
LIGHT_SPEED_AU = 137.03599967994

# Dipole
AU2DEBYE = 2.541746451895025

# IR intensity: (dmu/dQ)^2 [ (e*bohr / (bohr*sqrt(amu)) )^2 ] -> km/mol
# Standard prefactor used by PySCF's infrared module and the reference
# (opt-freq.py numerical_ir_intensities).
IR_KM_MOL = 42.2561

# Default thermochemistry conditions (reference: thermo.thermo(..., 298.15, 101325))
T_STANDARD = 298.15            # K
P_STANDARD = 101325.0          # Pa
